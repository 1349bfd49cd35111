"""Per-tensor entry points of the fused optimizer kernels (port of
repro/kernels/ops.py).

Each parameter tensor is viewed flat and handed to the kernels of
kernels/lans.py (K1-K4) and kernels/lamb.py (K5-K6) as it is: the CUDA
kernels take any length and mask their tail, so nothing is padded (the
JAX wrappers pad to (256, 128) tiles only because the TPU tiles that
way; zero padding was exact, so the results agree). CUDA tensors go through the kernels, CPU tensors
through their plain versions.

Step scalars are built on the operands' device from `eta` and `step`
(Python numbers or 0-d tensors), so a training step passes its device
count and schedule value through without a host round trip. The
optimizer transforms build a whole step's scalars at once
(lans_scalar_rows, lamb_scalar_rows) and hand each tensor its row.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import lamb as KB
from repro_torch.kernels import lans as K


class StepOut(NamedTuple):
    x: torch.Tensor   # new params, in x's dtype
    m: torch.Tensor   # new first moment, fp32
    v: torch.Tensor   # new second moment, fp32


class MixedStepOut(NamedTuple):
    """fused_lans_mixed_step result: fp32 master + low-precision copy."""

    x: torch.Tensor     # new master weights, fp32
    m: torch.Tensor
    v: torch.Tensor
    x_lp: torch.Tensor  # new model copy, lp_dtype (cast fused into K4)


def _flat(t):
    return t.reshape(-1).contiguous()


def _put(s, i, val):
    """s[i] = val, a Python number or a 0-d tensor (kept on the device)."""
    s[i] = (val.to(device=s.device, dtype=torch.float32)
            if torch.is_tensor(val) else float(val))


def lans_scalars(eta, step, *, beta1: float, beta2: float, lam: float,
                 apply_trust: bool, device) -> torch.Tensor:
    """The kernels' scalars [bc1, bc2, eta, lam, trust, g_sq=0, 0, 0] as
    an (8,) fp32 tensor on `device`. The bias corrections are
    1 - float32(beta) ** t in fp32, with t = `step` (1-indexed)."""
    s = torch.zeros(8, dtype=torch.float32, device=device)
    t = (step.to(device=device, dtype=torch.float32)
         if torch.is_tensor(step) else s.new_full((), float(step)))
    betas = s.new_empty(2)
    betas[0] = beta1
    betas[1] = beta2
    s[0:2] = 1.0 - torch.pow(betas, t)
    _put(s, 2, eta)
    s[3] = lam
    s[4] = 1.0 if apply_trust else 0.0
    return s


def _decay_rows(on, decay):
    """One row per tensor: `on` where decay[i], else `on` with lam 0 and
    trust off (slots 3-4)."""
    off = on.clone()
    off[3:5] = 0.0
    return torch.stack([on if d else off for d in decay])


def lans_scalar_rows(eta, step, decay, *, beta1: float, beta2: float,
                     lam: float, device) -> torch.Tensor:
    """The scalars of a whole step, one (8,) row per parameter tensor:
    lam and trust on where `decay[i]`, lam 0 and trust off elsewhere.
    bc1, bc2 and eta are the same in every row, so they are built once
    per step, not once per tensor; each row is contiguous and takes its
    tensor's g_sq from K1."""
    return _decay_rows(lans_scalars(eta, step, beta1=beta1, beta2=beta2,
                                    lam=lam, apply_trust=True,
                                    device=device), decay)


def _scalars(scalars, eta, step, beta1, beta2, lam, apply_trust, device):
    if scalars is not None:
        return scalars
    if eta is None or step is None:
        raise TypeError("give eta and step, or scalars")
    return lans_scalars(eta, step, beta1=beta1, beta2=beta2, lam=lam,
                        apply_trust=apply_trust, device=device)


def fused_lans_step(g, m, v, x, *, eta=None, step=None, beta1: float = 0.9,
                    beta2: float = 0.999, eps: float = 1e-6,
                    lam: float = 0.01, apply_trust: bool = True,
                    scalars: Optional[torch.Tensor] = None) -> StepOut:
    """One fused LANS update for a single parameter tensor (any shape):
    K1, K2, K3. Returns new tensors, x_new in x's dtype, moments fp32.
    `scalars` (a row of lans_scalar_rows, which K1 completes) stands in
    for eta, step, lam and apply_trust when given."""
    gf, mf, vf, xf = map(_flat, (g, m, v, x))
    scal = _scalars(scalars, eta, step, beta1, beta2, lam, apply_trust,
                    g.device)
    K.sq_norm(gf, out=scal[5:6])
    m_new, v_new, norms = K.lans_phase1(scal, gf, mf, vf, xf, beta1=beta1,
                                        beta2=beta2, eps=eps)
    x_new = K.lans_phase2(scal, norms, gf, m_new, v_new, xf, beta1=beta1,
                          eps=eps)
    return StepOut(x_new.view(x.shape), m_new.view(x.shape),
                   v_new.view(x.shape))


def fused_lans_mixed_step(g, m, v, x, *, eta=None, step=None, lp_dtype,
                          beta1: float = 0.9, beta2: float = 0.999,
                          eps: float = 1e-6, lam: float = 0.01,
                          apply_trust: bool = True,
                          scalars: Optional[torch.Tensor] = None
                          ) -> MixedStepOut:
    """Fused LANS step on the fp32 master `x` that also emits the lp_dtype
    model copy from the same pass: K1, K2, K4. `scalars` as in
    fused_lans_step."""
    gf, mf, vf, xf = map(_flat, (g, m, v, x))
    scal = _scalars(scalars, eta, step, beta1, beta2, lam, apply_trust,
                    g.device)
    K.sq_norm(gf, out=scal[5:6])
    m_new, v_new, norms = K.lans_phase1(scal, gf, mf, vf, xf, beta1=beta1,
                                        beta2=beta2, eps=eps)
    x_new, x_lp = K.lans_phase2_cast(scal, norms, gf, m_new, v_new, xf,
                                     lp_dtype=lp_dtype, beta1=beta1,
                                     eps=eps)
    return MixedStepOut(x_new.view(x.shape), m_new.view(x.shape),
                        v_new.view(x.shape), x_lp.view(x.shape))


def lamb_scalars(eta, step, clip, *, beta1: float, beta2: float,
                 lam: float, apply_trust: bool, device) -> torch.Tensor:
    """The LAMB kernels' scalars [bc1, bc2, eta, lam, trust, clip, 0, 0]:
    LANS's layout with the global clip factor (a Python number or a 0-d
    tensor) in slot 5."""
    s = lans_scalars(eta, step, beta1=beta1, beta2=beta2, lam=lam,
                     apply_trust=apply_trust, device=device)
    _put(s, 5, clip)
    return s


def lamb_scalar_rows(eta, step, clip, decay, *, beta1: float, beta2: float,
                     lam: float, device) -> torch.Tensor:
    """The LAMB scalars of a whole step, one (8,) row per parameter
    tensor: lam and trust on where `decay[i]`, lam 0 and trust off
    elsewhere. bc1, bc2, eta and clip are built once per step."""
    return _decay_rows(lamb_scalars(eta, step, clip, beta1=beta1,
                                    beta2=beta2, lam=lam, apply_trust=True,
                                    device=device), decay)


def fused_lamb_step(g, m, v, x, *, eta=None, step=None, clip=1.0,
                    beta1: float = 0.9, beta2: float = 0.999,
                    eps: float = 1e-6, lam: float = 0.01,
                    apply_trust: bool = True,
                    scalars: Optional[torch.Tensor] = None) -> StepOut:
    """One fused LAMB update for a single parameter tensor (any shape):
    K5, then K6. `clip` is the caller's global-clip factor. Returns new
    tensors, x_new in x's dtype, moments fp32. `scalars` (a row of
    lamb_scalar_rows) stands in for eta, step, clip, lam and apply_trust
    when given."""
    gf, mf, vf, xf = map(_flat, (g, m, v, x))
    if scalars is None:
        if eta is None or step is None:
            raise TypeError("give eta and step, or scalars")
        scalars = lamb_scalars(eta, step, clip, beta1=beta1, beta2=beta2,
                               lam=lam, apply_trust=apply_trust,
                               device=g.device)
    m_new, v_new, norms = KB.lamb_phase1(scalars, gf, mf, vf, xf,
                                         beta1=beta1, beta2=beta2, eps=eps)
    x_new = KB.lamb_phase2(scalars, norms, m_new, v_new, xf, eps=eps)
    return StepOut(x_new.view(x.shape), m_new.view(x.shape),
                   v_new.view(x.shape))


def block_sq_norm(x) -> torch.Tensor:
    """Kernel-backed sum of squares (K1) of a tensor of any shape."""
    return K.sq_norm(_flat(x))


# --------------------------------------------------------------------------
# leaves cut over ranks
# --------------------------------------------------------------------------
#
# On a mesh a rank holds one shard of a leaf, and each kernel runs on that
# shard alone. K1's g_sq and K2's / K5's norms are then partial sums of
# squares of the whole leaf: `reduce(stacked, key)` adds them over the
# ranks that share the leaf (key names its cut; () is a whole leaf, which
# needs nothing), for all the leaves with one key in one stacked call.
# So a step takes three passes over the leaves (K1, then K2 or K5, then
# K3, K4 or K6) and two small reductions per key, where the one-device
# step runs K1-K3 leaf by leaf.

def _reduce_grouped(values, keys, reduce):
    """values[i] (tensors of one shape) summed over the ranks of keys[i]:
    one reduce call per distinct non-empty key, on the stacked values of
    its leaves. Returns the list of summed values."""
    out = list(values)
    for key in dict.fromkeys(k for k in keys if k):
        idx = [i for i, k in enumerate(keys) if k == key]
        summed = reduce(torch.stack([values[i] for i in idx]), key)
        for j, i in enumerate(idx):
            out[i] = summed[j]
    return out


def sharded_sq_norms(gs, keys, reduce) -> list:
    """K1 on each local shard in `gs`, summed over its key's ranks: the
    whole leaves' sums of squares (0-d tensors)."""
    return _reduce_grouped([K.sq_norm(_flat(g)) for g in gs], keys, reduce)


def sharded_lans_steps(items, keys, reduce, *, beta1: float = 0.9,
                       beta2: float = 0.999, eps: float = 1e-6,
                       lp_dtypes=None) -> list:
    """fused_lans_step (or, with lp_dtypes, fused_lans_mixed_step with
    lp_dtypes[i]) on local shards: items[i] = (g, m, v, x, scalars row).
    K1 on every shard, g_sq summed per key into each row's slot 5; K2 on
    every shard, its norms summed per key; then K3 (K4) on every shard.
    Returns StepOut (MixedStepOut) per item, of the local shapes."""
    flat = [tuple(map(_flat, it[:4])) for it in items]
    rows = [it[4] for it in items]
    g_sq = sharded_sq_norms([f[0] for f in flat], keys, reduce)
    for row, s in zip(rows, g_sq):
        row[5] = s
    p1 = [K.lans_phase1(row, gf, mf, vf, xf, beta1=beta1, beta2=beta2,
                        eps=eps) for row, (gf, mf, vf, xf) in zip(rows, flat)]
    norms = _reduce_grouped([p[2] for p in p1], keys, reduce)
    out = []
    for i, ((gf, _, _, xf), row, (m_new, v_new, _)) in enumerate(
            zip(flat, rows, p1)):
        shape = items[i][3].shape
        if lp_dtypes is None:
            x_new = K.lans_phase2(row, norms[i], gf, m_new, v_new, xf,
                                  beta1=beta1, eps=eps)
            out.append(StepOut(x_new.view(shape), m_new.view(shape),
                               v_new.view(shape)))
        else:
            x_new, x_lp = K.lans_phase2_cast(row, norms[i], gf, m_new, v_new,
                                             xf, lp_dtype=lp_dtypes[i],
                                             beta1=beta1, eps=eps)
            out.append(MixedStepOut(x_new.view(shape), m_new.view(shape),
                                    v_new.view(shape), x_lp.view(shape)))
    return out


def sharded_lamb_steps(items, keys, reduce, *, beta1: float = 0.9,
                       beta2: float = 0.999, eps: float = 1e-6) -> list:
    """fused_lamb_step on local shards: items[i] = (g, m, v, x, row), the
    rows carrying the global clip factor. K5 on every shard, its norms
    summed per key, then K6 on every shard. Returns StepOut per item."""
    flat = [tuple(map(_flat, it[:4])) for it in items]
    p1 = [KB.lamb_phase1(it[4], gf, mf, vf, xf, beta1=beta1, beta2=beta2,
                         eps=eps) for it, (gf, mf, vf, xf) in zip(items, flat)]
    norms = _reduce_grouped([p[2] for p in p1], keys, reduce)
    out = []
    for i, (it, (_, _, _, xf), (m_new, v_new, _)) in enumerate(
            zip(items, flat, p1)):
        x_new = KB.lamb_phase2(it[4], norms[i], m_new, v_new, xf, eps=eps)
        shape = it[3].shape
        out.append(StepOut(x_new.view(shape), m_new.view(shape),
                           v_new.view(shape)))
    return out
