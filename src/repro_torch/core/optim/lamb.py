"""LAMB — Algorithm 1 (You et al., ICLR 2020), the paper's primary
baseline (port of repro/core/optim/lamb.py).

    m_t = b1*m + (1-b1)*g          v_t = b2*v + (1-b2)*g^2
    r_t = m~_t / (sqrt(v~_t) + eps)
    x  <- x - eta_t * phi(||x||) / ||r_t + lam*x|| * (r_t + lam*x)

Shares the block conventions of lans.py: a block is one parameter tensor
(so one trust ratio spans BERT's 24 stacked layers, ROADMAP Queue 3),
and a block outside the decay mask gets lam 0 and trust 1. Unlike LANS,
LAMB clips the gradient globally first: the norm is summed over all
leaves in tree order and every gradient is scaled by
min(1, grad_clip_norm / max(norm, 1e-12)). The fused route, on kernels
K5-K6, is core/optim/fused.py:fused_lamb.
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
    safe_norm,
    scale_by_schedule,
    tree_device,
    tree_leaves,
    tree_map,
    tree_paths,
)


class LambState(NamedTuple):
    count: torch.Tensor  # int32 0-d, number of completed steps
    mu: Any              # first moment tree, fp32
    nu: Any              # second moment tree, fp32


def clip_factor(sq: torch.Tensor, grad_clip_norm: float) -> torch.Tensor:
    """min(1, c / max(sqrt(sq), 1e-12)): the global clip factor, a 0-d
    fp32 tensor on sq's device, from the gradients' summed squares."""
    norm = torch.sqrt(sq)
    return torch.clamp(grad_clip_norm / torch.clamp(norm, min=1e-12),
                       max=1.0)


def global_clip(grads, grad_clip_norm: float) -> torch.Tensor:
    """The clip factor of `grads`, the sum of squares taken leaf by leaf
    in tree order (as the reference's Python sum)."""
    return clip_factor(sum(torch.sum(g.float() * g.float())
                           for g in tree_leaves(grads)), grad_clip_norm)


def _lamb_block_update(g, m, v, x, *, count, beta1: float, beta2: float,
                       eps: float, weight_decay: float,
                       decay_this_block: bool,
                       phi_clip: Optional[tuple] = None, clip=None):
    """One LAMB step for a single block: (direction, new_m, new_v); the
    caller applies x <- x - eta*d. All math in fp32."""
    g = g.float()
    x32 = x.float()
    lam = weight_decay if decay_this_block else 0.0
    if clip is not None:
        g = g * clip

    m_new = beta1 * m + (1.0 - beta1) * g
    v_new = beta2 * v + (1.0 - beta2) * (g * g)

    t = count + 1
    m_hat = m_new / bias_correction(beta1, t)
    v_hat = v_new / bias_correction(beta2, t)

    r = m_hat / (torch.sqrt(v_hat) + eps)
    u = r + lam * x32

    phi = safe_norm(x32)
    if phi_clip is not None:
        phi = torch.clamp(phi, phi_clip[0], phi_clip[1])
    u_norm = safe_norm(u)
    one = torch.ones_like(phi)
    trust = torch.where(u_norm > 0, phi / torch.clamp(u_norm, min=1e-38),
                        one)
    if not decay_this_block:
        trust = one
    return (trust * u).to(x.dtype), m_new, v_new


def scale_by_lamb(beta1: float = 0.9, beta2: float = 0.999,
                  eps: float = 1e-6, weight_decay: float = 0.01,
                  decay_mask: Optional[Callable[[str], bool]] = None,
                  phi_clip: Optional[tuple] = None,
                  grad_clip_norm: Optional[float] = 1.0
                  ) -> GradientTransformation:
    """LAMB direction transform (Algorithm 1, without the -eta_t factor)."""
    mask_fn = decay_mask or WeightDecayMask()

    def init_fn(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return LambState(
            count=torch.zeros((), dtype=torch.int32,
                              device=tree_device(params)),
            mu=tree_map(zeros, params), nu=tree_map(zeros, params))

    def update_fn(updates, state, params):
        if params is None:
            raise ValueError("LAMB requires params.")
        clip = (None if grad_clip_norm is None
                else global_clip(updates, grad_clip_norm))
        outs = tree_map(
            lambda g, m, v, x, pth: _lamb_block_update(
                g, m, v, x, count=state.count, beta1=beta1, beta2=beta2,
                eps=eps, weight_decay=weight_decay,
                decay_this_block=bool(mask_fn(pth)), phi_clip=phi_clip,
                clip=clip),
            updates, state.mu, state.nu, params, tree_paths(params))
        pick = lambda i: tree_map(lambda o: o[i], outs)
        return pick(0), LambState(count=state.count + 1, mu=pick(1),
                                  nu=pick(2))

    return GradientTransformation(init_fn, update_fn)


def lamb(learning_rate, beta1: float = 0.9, beta2: float = 0.999,
         eps: float = 1e-6, weight_decay: float = 0.01,
         decay_mask: Optional[Callable[[str], bool]] = None,
         phi_clip: Optional[tuple] = None,
         grad_clip_norm: Optional[float] = 1.0) -> GradientTransformation:
    """Full LAMB optimizer: direction transform x (-eta_t)."""
    return chain(
        scale_by_lamb(beta1, beta2, eps, weight_decay, decay_mask, phi_clip,
                      grad_clip_norm),
        scale_by_schedule(as_schedule(learning_rate)),
    )
