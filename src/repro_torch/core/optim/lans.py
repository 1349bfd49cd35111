"""LANS — the paper's Algorithm 2 (port of repro/core/optim/lans.py).

Differences from LAMB (Algorithm 1), per paper §3:

  1. Per-block gradient normalization (eq. 4):
         g~_b = g_b / ||g_b||_2
     applied BEFORE the Adam moment updates.

  2. Nesterov-style update (eq. 7): convex combination of two separately
     normalized directions,
         d_b = phi(||x_b||) * [ beta1   * (r_b + lam*x_b)/||r_b + lam*x_b||
                              + (1-b1)  * (c_b + lam*x_b)/||c_b + lam*x_b|| ]
     with r_b = m~_b / (sqrt(v~_b) + eps) the bias-corrected trust direction
     and  c_b = g~_b / (sqrt(v~_b) + eps) the momentum-free direction
     (no 1/(1-beta1^t) on c_b, as in the paper).

A "block" is one parameter tensor (a leaf of the tree). BERT's layers are
stacked on a leading axis, so one block spans all of them (ROADMAP
Queue 3). This is the unfused path the training CLI runs; the fused one,
on the hand-written kernels, is core/optim/fused.py.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core.optim.base import (
    GradientTransformation,
    WeightDecayMask,
    as_schedule,
    bias_correction,
    chain,
    safe_div,
    safe_norm,
    scale_by_schedule,
    tree_consume,
    tree_device,
    tree_map,
    tree_paths,
)


class LansState(NamedTuple):
    count: torch.Tensor  # int32 0-d, number of completed steps
    mu: Any              # first moment tree
    nu: Any              # second moment tree


def _lans_block_update(g, m, v, x, *, count, beta1: float, beta2: float,
                       eps: float, weight_decay: float,
                       decay_this_block: bool,
                       phi_clip: Optional[tuple] = None,
                       normalize_grads: bool = True, nesterov: bool = True):
    """One LANS step for a single block. Returns (direction, new_m, new_v).

    ``direction`` is the positive step d_t; the caller applies
    x <- x - eta*d. All math in fp32 whatever the input dtypes.
    """
    g = g.float()
    x32 = x.float()
    mu_dtype = m.dtype
    m = m.float()
    v = v.float()
    lam = weight_decay if decay_this_block else 0.0

    # eq. (4): blockwise gradient normalization.
    g_tilde = safe_div(g, safe_norm(g)) if normalize_grads else g

    m_new = beta1 * m + (1.0 - beta1) * g_tilde
    v_new = beta2 * v + (1.0 - beta2) * (g_tilde * g_tilde)

    # count is the completed-steps counter; this step is t = count + 1.
    # Each intermediate is dropped once used: at a full-size leaf they are
    # what sets the update's peak memory.
    t = count + 1
    m_hat = m_new / bias_correction(beta1, t)
    denom = torch.sqrt(v_new / bias_correction(beta2, t)) + eps
    r = m_hat / denom
    del m_hat
    c = g_tilde / denom
    del denom, g_tilde

    r_full = r + lam * x32
    del r
    c_full = c + lam * x32
    del c

    phi = safe_norm(x32)
    if phi_clip is not None:
        phi = torch.clamp(phi, phi_clip[0], phi_clip[1])
    r_n = safe_norm(r_full)
    c_n = safe_norm(c_full)
    one = torch.ones_like(phi)
    scale_r = torch.where(r_n > 0, phi / torch.clamp(r_n, min=1e-38), one)
    scale_c = torch.where(c_n > 0, phi / torch.clamp(c_n, min=1e-38), one)
    if not decay_this_block:
        # phi == 1 and no trust normalization for the excluded blocks
        scale_r = scale_c = one

    if nesterov:
        d = beta1 * scale_r * r_full + (1.0 - beta1) * scale_c * c_full
    else:
        d = scale_r * r_full   # classic-momentum LAMB-style update
    return d.to(x.dtype), m_new.to(mu_dtype), v_new.to(mu_dtype)


def scale_by_lans(beta1: float = 0.9, beta2: float = 0.999,
                  eps: float = 1e-6, weight_decay: float = 0.01,
                  decay_mask: Optional[Callable[[str], bool]] = None,
                  phi_clip: Optional[tuple] = None,
                  mu_dtype=torch.float32, normalize_grads: bool = True,
                  nesterov: bool = True) -> GradientTransformation:
    """LANS direction transform (Algorithm 2, without the -eta_t factor).

    mu_dtype: storage dtype of the moments (math is always fp32).
    normalize_grads / nesterov: ablation switches for eq. 4 and eq. 7;
    both False is LAMB without clipping.
    """
    mask_fn = decay_mask or WeightDecayMask()

    def init_fn(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=mu_dtype,
                                      device=p.device)
        return LansState(
            count=torch.zeros((), dtype=torch.int32,
                              device=tree_device(params)),
            mu=tree_map(zeros, params), nu=tree_map(zeros, params))

    def update_fn(updates, state, params):
        if params is None:
            raise ValueError("LANS requires params (trust-ratio + weight "
                             "decay).")
        box = [updates]           # the only reference: see tree_consume
        del updates
        outs = tree_consume(
            lambda g, m, v, x, pth: _lans_block_update(
                g, m, v, x, count=state.count, beta1=beta1, beta2=beta2,
                eps=eps, weight_decay=weight_decay,
                decay_this_block=bool(mask_fn(pth)), phi_clip=phi_clip,
                normalize_grads=normalize_grads, nesterov=nesterov),
            box.pop(), state.mu, state.nu, params, tree_paths(params))
        pick = lambda i: tree_map(lambda o: o[i], outs)
        return pick(0), LansState(count=state.count + 1, mu=pick(1),
                                  nu=pick(2))

    return GradientTransformation(init_fn, update_fn)


def lans(learning_rate, beta1: float = 0.9, beta2: float = 0.999,
         eps: float = 1e-6, weight_decay: float = 0.01,
         decay_mask: Optional[Callable[[str], bool]] = None,
         phi_clip: Optional[tuple] = None, mu_dtype=torch.float32,
         normalize_grads: bool = True,
         nesterov: bool = True) -> GradientTransformation:
    """Full LANS optimizer: direction transform x (-eta_t)."""
    return chain(
        scale_by_lans(beta1, beta2, eps, weight_decay, decay_mask, phi_clip,
                      mu_dtype, normalize_grads, nesterov),
        scale_by_schedule(as_schedule(learning_rate)),
    )
