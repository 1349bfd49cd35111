"""The fused LANS step's four kernels, each beside its plain version.

  K1 sq_norm           sum of squares of a tensor, in fp32
  K2 lans_phase1       g~ = g / ||g||, new m and v, and the norms
                       [||r + lam x||^2, ||c + lam x||^2, ||x||^2, 0 x 5]
  K3 lans_phase2       trust ratios, d = b1 sr r + (1 - b1) sc c,
                       x <- x - eta d in x's dtype
  K4 lans_phase2_cast  K3 on an fp32 master that also writes its bf16 /
                       fp16 copy (an fp32 "copy", which mixed policies
                       ask for on the leaves they keep in fp32, is the
                       master itself: one output, as in K3's pass)

They replace the TPU kernels of `repro/kernels/lans_kernel.py`; the CUDA
source is `csrc/lans.cu`. On CUDA tensors a wrapper launches the kernel
(and counts it in `<wrapper>.launches`) or raises; on CPU tensors it runs
the `*_plain` version, which mirrors lans_kernel.py phase by phase and,
composed, `repro/kernels/ref.py:lans_step_ref`. Neither falls back to
the other.

Operands are flat and contiguous, of any length (ops.py flattens each
parameter). g and x are fp32 or bf16, m and v fp32. The per-step scalars
are an 8-float tensor on the operands' device, laid out as the TPU
kernels' (1, 8) operand: [bc1, bc2, eta, lam, trust, g_sq, 0, 0]; the
norms K2 returns are another 8-float tensor. Neither is read back to the
host.

Each kernel's cost (`*_cost`: FLOPs and the bytes it must move, each
operand read once and each output written once) is kept here: the
bounds of chip_smoke.py and the dry run (launch/dryrun.py) both read it.
On a meta tensor a wrapper runs its stand-in, which returns outputs of
the kernel's shapes and dtypes and charges that cost to the tracer in
force (launch/trace_cost.py: charge_kernel).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels.optim_common import (
    DTYPE_CODE, GX_TYPES, MAX_PARTS, charge, check, check_max_parts,
    check_operands, on_cuda, ptr, raise_on, stand_in, stream, trust_ratio)

_LP_TYPES = (torch.bfloat16, torch.float16, torch.float32)


# --------------------------------------------------------------------------
# plain versions (lans_kernel.py, phase by phase)
# --------------------------------------------------------------------------

def _g_tilde(g, g_sq):
    """g / sqrt(g_sq), selecting 0 where g_sq is 0 or NaN (select, not
    multiply: g * 0 would keep a NaN)."""
    g = g.float()
    inv = torch.rsqrt(torch.clamp(g_sq, min=1e-38))
    return torch.where(g_sq > 0.0, g * inv, torch.zeros_like(g))


def sq_norm_plain(x) -> torch.Tensor:
    """K1: sum of squares in fp32, a 0-d tensor."""
    x = x.float()
    return torch.sum(x * x)


def lans_phase1_plain(scalars, g, m, v, x, *, beta1, beta2, eps):
    """K2: (m_new, v_new, norms (8,)); norms = [r_sq, c_sq, x_sq, 0...]."""
    bc1, bc2, lam, g_sq = scalars[0], scalars[1], scalars[3], scalars[5]
    g_t = _g_tilde(g, g_sq)
    x = x.float()
    m_new = beta1 * m.float() + (1.0 - beta1) * g_t
    v_new = beta2 * v.float() + (1.0 - beta2) * (g_t * g_t)
    denom = torch.sqrt(v_new / bc2) + eps
    r_full = (m_new / bc1) / denom + lam * x
    c_full = g_t / denom + lam * x
    norms = torch.zeros(8, dtype=torch.float32, device=x.device)
    norms[0] = torch.sum(r_full * r_full)
    norms[1] = torch.sum(c_full * c_full)
    norms[2] = torch.sum(x * x)
    return m_new, v_new, norms


def _phase2_x_new_plain(scalars, norms, g, m, v, x, *, beta1, eps):
    """The fp32 updated x - eta * d shared by K3 and K4."""
    bc1, bc2, eta, lam = scalars[0], scalars[1], scalars[2], scalars[3]
    trust, g_sq = scalars[4], scalars[5]
    g_t = _g_tilde(g, g_sq)
    x = x.float()
    denom = torch.sqrt(v.float() / bc2) + eps
    r_full = (m.float() / bc1) / denom + lam * x
    c_full = g_t / denom + lam * x
    x_norm = torch.sqrt(norms[2])
    sr = trust_ratio(x_norm, norms[0], trust)
    sc = trust_ratio(x_norm, norms[1], trust)
    d = beta1 * sr * r_full + (1.0 - beta1) * sc * c_full
    return x - eta * d


def lans_phase2_plain(scalars, norms, g, m, v, x, *, beta1, eps):
    """K3: x_new in x's dtype."""
    return _phase2_x_new_plain(scalars, norms, g, m, v, x, beta1=beta1,
                               eps=eps).to(x.dtype)


def lans_phase2_cast_plain(scalars, norms, g, m, v, x, *, lp_dtype, beta1,
                           eps):
    """K4: (x_new fp32, x_new cast to lp_dtype)."""
    x_new = _phase2_x_new_plain(scalars, norms, g, m, v, x, beta1=beta1,
                                eps=eps)
    return x_new, x_new.to(lp_dtype)   # the same tensor for fp32


# --------------------------------------------------------------------------
# costs: (FLOPs, bytes) of one launch on n elements; the FLOPs are fp32,
# outside the tensor cores
# --------------------------------------------------------------------------

def sq_norm_cost(x):
    """K1: x read once; a square and an add per element."""
    n = x.numel()
    return 2 * n, n * x.element_size()


def lans_phase1_cost(g, x):
    """K2: g, m, v and x read, the new m and v written (fp32 moments)."""
    n = x.numel()
    return 24 * n, n * (g.element_size() + x.element_size() + 16)


def lans_phase2_cost(g, x, lp_dtype=None):
    """K3 (lp_dtype None) or K4: g, m, v and x read, x written, and K4's
    copy in lp_dtype unless that is fp32 (the master itself)."""
    n = x.numel()
    lp = (torch.empty((), dtype=lp_dtype).element_size()
          if lp_dtype not in (None, torch.float32) else 0)
    return 16 * n, n * (g.element_size() + 2 * x.element_size() + 8 + lp)


# --------------------------------------------------------------------------
# the wrappers
# --------------------------------------------------------------------------

def _library():
    from repro_torch.kernels import build
    lib = build.load("lans")
    if lib.lans_sq_norm_launch.argtypes is None:
        P, I, L, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                      ctypes.c_float)
        check_max_parts(lib, "lans_max_parts", "lans.cu")
        lib.lans_sq_norm_launch.argtypes = [P, I, L, P, P, P]
        lib.lans_phase1_launch.argtypes = [P, P, I, P, P, P, I, P, P, L,
                                           F, F, F, F, F, P, P, P]
        lib.lans_phase2_launch.argtypes = [P, P, P, I, P, P, P, I, P, P, I,
                                           L, F, F, F, P]
        for fn in (lib.lans_sq_norm_launch, lib.lans_phase1_launch,
                   lib.lans_phase2_launch):
            fn.restype = I
    return lib


def sq_norm(x, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1: sum of squares of a flat fp32/bf16 tensor, in fp32. Written
    into `out` (a 1-element fp32 tensor, e.g. the g_sq slot of the
    scalars) when given; returned as a 0-d tensor."""
    if stand_in(x):
        charge("sq_norm", sq_norm_cost(x))
        return (out.reshape(()) if out is not None else
                torch.empty((), dtype=torch.float32, device=x.device))
    if not on_cuda(x, "sq_norm"):
        val = sq_norm_plain(x)
        if out is None:
            return val
        out.copy_(val.reshape(out.shape))
        return out.reshape(())
    check("x", x, x.device, GX_TYPES)
    if out is None:
        out = torch.empty(1, dtype=torch.float32, device=x.device)
    check("out", out, x.device, (torch.float32,), 1)
    parts = torch.empty(MAX_PARTS, dtype=torch.float32, device=x.device)
    err = _library().lans_sq_norm_launch(
        ptr(x), DTYPE_CODE[x.dtype], x.numel(), ptr(parts), ptr(out),
        stream(x))
    raise_on(err, "sq_norm")
    sq_norm.launches += 1
    return out.reshape(())


def lans_phase1(scalars, g, m, v, x, *, beta1, beta2, eps
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2: (m_new, v_new, norms). New tensors; the inputs are not
    written."""
    if stand_in(g):
        charge("lans_phase1", lans_phase1_cost(g, x))
        return (torch.empty_like(m), torch.empty_like(v),
                torch.empty(8, dtype=torch.float32, device=g.device))
    if not on_cuda(g, "lans_phase1"):
        return lans_phase1_plain(scalars, g, m, v, x, beta1=beta1,
                                 beta2=beta2, eps=eps)
    check_operands(scalars, None, g, m, v, x)
    m_new, v_new = torch.empty_like(m), torch.empty_like(v)
    norms = torch.empty(8, dtype=torch.float32, device=g.device)
    parts = torch.empty(3 * MAX_PARTS, dtype=torch.float32, device=g.device)
    err = _library().lans_phase1_launch(
        ptr(scalars), ptr(g), DTYPE_CODE[g.dtype], ptr(m), ptr(v), ptr(x),
        DTYPE_CODE[x.dtype], ptr(m_new), ptr(v_new), g.numel(), beta1,
        1.0 - beta1, beta2, 1.0 - beta2, eps, ptr(parts), ptr(norms),
        stream(g))
    raise_on(err, "lans_phase1")
    lans_phase1.launches += 1
    return m_new, v_new, norms


def _phase2(scalars, norms, g, m, v, x, lp_dtype, beta1, eps):
    check_operands(scalars, norms, g, m, v, x)
    x_new = torch.empty_like(x)
    # an fp32 copy of the fp32 master is the master: write it once
    cast = lp_dtype not in (None, torch.float32)
    lp = (torch.empty(x.shape, dtype=lp_dtype, device=x.device) if cast
          else x_new)
    err = _library().lans_phase2_launch(
        ptr(scalars), ptr(norms), ptr(g), DTYPE_CODE[g.dtype], ptr(m),
        ptr(v), ptr(x), DTYPE_CODE[x.dtype], ptr(x_new),
        ctypes.c_void_p(lp.data_ptr() if cast else None),
        DTYPE_CODE[lp_dtype] if cast else 0, g.numel(), beta1, 1.0 - beta1,
        eps, stream(g))
    return x_new, lp, err


def lans_phase2(scalars, norms, g, m, v, x, *, beta1, eps) -> torch.Tensor:
    """K3: x_new in x's dtype (m, v are K2's new moments)."""
    if stand_in(g):
        charge("lans_phase2", lans_phase2_cost(g, x))
        return torch.empty_like(x)
    if not on_cuda(g, "lans_phase2"):
        return lans_phase2_plain(scalars, norms, g, m, v, x, beta1=beta1,
                                 eps=eps)
    x_new, _, err = _phase2(scalars, norms, g, m, v, x, None, beta1, eps)
    raise_on(err, "lans_phase2")
    lans_phase2.launches += 1
    return x_new


def lans_phase2_cast(scalars, norms, g, m, v, x, *, lp_dtype, beta1, eps
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: (x_new fp32, x_new in lp_dtype) from an fp32 master x, in one
    pass. lp_dtype fp32 returns the master twice (the same tensor)."""
    if stand_in(g):
        charge("lans_phase2_cast", lans_phase2_cost(g, x, lp_dtype))
        x_new = torch.empty_like(x)
        return x_new, (x_new if lp_dtype == torch.float32 else
                       torch.empty(x.shape, dtype=lp_dtype, device=x.device))
    if not on_cuda(g, "lans_phase2_cast"):
        return lans_phase2_cast_plain(scalars, norms, g, m, v, x,
                                      lp_dtype=lp_dtype, beta1=beta1,
                                      eps=eps)
    if x.dtype != torch.float32:
        raise TypeError(f"lans_phase2_cast needs an fp32 master, got "
                        f"{x.dtype}")
    if lp_dtype not in _LP_TYPES:
        raise TypeError(f"lp_dtype must be one of {_LP_TYPES}, got "
                        f"{lp_dtype}")
    x_new, lp, err = _phase2(scalars, norms, g, m, v, x, lp_dtype, beta1,
                             eps)
    raise_on(err, "lans_phase2_cast")
    lans_phase2_cast.launches += 1
    return x_new, lp


for _fn in (sq_norm, lans_phase1, lans_phase2, lans_phase2_cast):
    _fn.launches = 0
KERNELS = (sq_norm, lans_phase1, lans_phase2, lans_phase2_cast)


def lans_case(n: int, dtype=torch.float32, *, kind: str = "normal",
              seed: int = 0, device="cpu"):
    """(g, m, v, x), flat, of n elements, drawn with numpy from `seed`:
    g and x in `dtype`, m and v fp32 (v >= 0). kind "zero_grad" makes g
    all zeros, "nan_grad" plants a NaN in g. The cases of the kernel
    tests and of chip_smoke.py."""
    import numpy as np
    rng = np.random.default_rng(seed)
    g, m, x = (rng.standard_normal(n, np.float32) for _ in range(3))
    v = np.abs(rng.standard_normal(n, np.float32))
    if kind == "zero_grad":
        g[:] = 0.0
    elif kind == "nan_grad":
        g[n // 2] = np.nan
    elif kind != "normal":
        raise ValueError(f"unknown case kind {kind!r}")
    t = lambda a, dt: torch.from_numpy(a).to(device=device, dtype=dt)
    return t(g, dtype), t(m, torch.float32), t(v, torch.float32), t(x, dtype)
