"""The fused LAMB step's two kernels, each beside its plain version.

  K5 lamb_phase1   g * clip, new m and v, and the norms
                   [||u||^2, ||x||^2, 0 x 6], u = m~ / (sqrt(v~) + eps) + lam x
  K6 lamb_phase2   trust = ||x|| / ||u||, x <- x - eta trust u in x's dtype

They replace the TPU kernels of `repro/kernels/lamb_kernel.py`; the CUDA
source is `csrc/lamb.cu`. On CUDA tensors a wrapper launches the kernel
(and counts it in `<wrapper>.launches`) or raises; on CPU tensors it runs
the `*_plain` version, which mirrors lamb_kernel.py phase by phase and,
composed, `repro/kernels/ref.py:lamb_step_ref`. Neither falls back to
the other.

Operands are flat and contiguous, of any length. g and x are fp32 or
bf16, m and v fp32. The per-step scalars are an 8-float tensor on the
operands' device, laid out as the TPU kernels' (1, 8) operand:
[bc1, bc2, eta, lam, trust, clip, 0, 0] (slot 5 is the global clip
factor, where LANS keeps g_sq). Neither they nor the norms K5 returns
are read back to the host.

Each kernel's cost (`*_cost`: FLOPs and the bytes it must move) is kept
here, and on a meta tensor a wrapper runs its stand-in, as in
kernels/lans.py.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels.optim_common import (
    DTYPE_CODE, MAX_PARTS, charge, check_max_parts, check_operands, on_cuda,
    ptr, raise_on, stand_in, stream, trust_ratio)


# --------------------------------------------------------------------------
# plain versions (lamb_kernel.py, phase by phase)
# --------------------------------------------------------------------------

def _u(scalars, m, v, x, eps):
    bc1, bc2, lam = scalars[0], scalars[1], scalars[3]
    return (m / bc1) / (torch.sqrt(v / bc2) + eps) + lam * x


def lamb_phase1_plain(scalars, g, m, v, x, *, beta1, beta2, eps):
    """K5: (m_new, v_new, norms (8,)); norms = [u_sq, x_sq, 0...]."""
    g = g.float() * scalars[5]
    x = x.float()
    m_new = beta1 * m.float() + (1.0 - beta1) * g
    v_new = beta2 * v.float() + (1.0 - beta2) * (g * g)
    u = _u(scalars, m_new, v_new, x, eps)
    norms = torch.zeros(8, dtype=torch.float32, device=x.device)
    norms[0] = torch.sum(u * u)
    norms[1] = torch.sum(x * x)
    return m_new, v_new, norms


def lamb_phase2_plain(scalars, norms, m, v, x, *, eps):
    """K6: x_new in x's dtype (m, v are K5's new moments)."""
    eta, flag = scalars[2], scalars[4]
    xf = x.float()
    u = _u(scalars, m.float(), v.float(), xf, eps)
    trust = trust_ratio(torch.sqrt(norms[1]), norms[0], flag)
    return (xf - eta * trust * u).to(x.dtype)


# --------------------------------------------------------------------------
# costs: (FLOPs, bytes) of one launch on n elements, as kernels/lans.py's
# --------------------------------------------------------------------------

def lamb_phase1_cost(g, x):
    """K5: g, m, v and x read, the new m and v written (fp32 moments)."""
    n = x.numel()
    return 20 * n, n * (g.element_size() + x.element_size() + 16)


def lamb_phase2_cost(x):
    """K6: m, v and x read, x written."""
    n = x.numel()
    return 10 * n, n * (2 * x.element_size() + 8)


# --------------------------------------------------------------------------
# the wrappers
# --------------------------------------------------------------------------

def _library():
    from repro_torch.kernels import build
    lib = build.load("lamb")
    if lib.lamb_phase1_launch.argtypes is None:
        P, I, L, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                      ctypes.c_float)
        check_max_parts(lib, "lamb_max_parts", "lamb.cu")
        lib.lamb_phase1_launch.argtypes = [P, P, I, P, P, P, I, P, P, L,
                                           F, F, F, F, F, P, P, P]
        lib.lamb_phase2_launch.argtypes = [P, P, P, P, P, I, P, L, F, P]
        for fn in (lib.lamb_phase1_launch, lib.lamb_phase2_launch):
            fn.restype = I
    return lib


def lamb_phase1(scalars, g, m, v, x, *, beta1, beta2, eps
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5: (m_new, v_new, norms). New tensors; the inputs are not
    written."""
    if stand_in(g):
        charge("lamb_phase1", lamb_phase1_cost(g, x))
        return (torch.empty_like(m), torch.empty_like(v),
                torch.empty(8, dtype=torch.float32, device=g.device))
    if not on_cuda(g, "lamb_phase1"):
        return lamb_phase1_plain(scalars, g, m, v, x, beta1=beta1,
                                 beta2=beta2, eps=eps)
    check_operands(scalars, None, g, m, v, x)
    m_new, v_new = torch.empty_like(m), torch.empty_like(v)
    norms = torch.empty(8, dtype=torch.float32, device=g.device)
    parts = torch.empty(2 * MAX_PARTS, dtype=torch.float32, device=g.device)
    err = _library().lamb_phase1_launch(
        ptr(scalars), ptr(g), DTYPE_CODE[g.dtype], ptr(m), ptr(v), ptr(x),
        DTYPE_CODE[x.dtype], ptr(m_new), ptr(v_new), g.numel(), beta1,
        1.0 - beta1, beta2, 1.0 - beta2, eps, ptr(parts), ptr(norms),
        stream(g))
    raise_on(err, "lamb_phase1")
    lamb_phase1.launches += 1
    return m_new, v_new, norms


def lamb_phase2(scalars, norms, m, v, x, *, eps) -> torch.Tensor:
    """K6: x_new in x's dtype (m, v are K5's new moments)."""
    if stand_in(x):
        charge("lamb_phase2", lamb_phase2_cost(x))
        return torch.empty_like(x)
    if not on_cuda(x, "lamb_phase2"):
        return lamb_phase2_plain(scalars, norms, m, v, x, eps=eps)
    check_operands(scalars, norms, None, m, v, x)
    x_new = torch.empty_like(x)
    err = _library().lamb_phase2_launch(
        ptr(scalars), ptr(norms), ptr(m), ptr(v), ptr(x),
        DTYPE_CODE[x.dtype], ptr(x_new), x.numel(), eps, stream(x))
    raise_on(err, "lamb_phase2")
    lamb_phase2.launches += 1
    return x_new


for _fn in (lamb_phase1, lamb_phase2):
    _fn.launches = 0
KERNELS = (lamb_phase1, lamb_phase2)
