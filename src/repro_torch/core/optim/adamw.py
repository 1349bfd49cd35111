"""AdamW (Loshchilov & Hutter) and the paper's finetuning variant, AdamW
with per-block gradient normalization first (eq. 4), "BN-AdamW"; and SGD
with classic or Nesterov momentum (paper §2.2, eqs. 2-3). Port of
repro/core/optim/adamw.py; none of them has a kernel.
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
    identity,
    safe_div,
    safe_norm,
    scale_by_schedule,
    tree_device,
    tree_map,
    tree_paths,
)


class AdamWState(NamedTuple):
    count: torch.Tensor  # int32 0-d, number of completed steps
    mu: Any              # fp32
    nu: Any              # fp32


def scale_by_adamw(beta1: float = 0.9, beta2: float = 0.999,
                   eps: float = 1e-6, weight_decay: float = 0.01,
                   decay_mask: Optional[Callable[[str], bool]] = None,
                   block_normalize: bool = False) -> GradientTransformation:
    """AdamW direction; block_normalize=True applies paper eq. (4)
    first."""
    mask_fn = decay_mask or WeightDecayMask()

    def init_fn(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return AdamWState(
            count=torch.zeros((), dtype=torch.int32,
                              device=tree_device(params)),
            mu=tree_map(zeros, params), nu=tree_map(zeros, params))

    def update_fn(updates, state, params):
        if params is None:
            raise ValueError("AdamW (decoupled decay) requires params.")
        t = state.count + 1
        bc1, bc2 = bias_correction(beta1, t), bias_correction(beta2, t)

        def block(g, m, v, x, pth):
            g = g.float()
            if block_normalize:
                g = safe_div(g, safe_norm(g))
            m_new = beta1 * m + (1.0 - beta1) * g
            v_new = beta2 * v + (1.0 - beta2) * (g * g)
            d = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
            if mask_fn(pth):
                d = d + weight_decay * x.float()
            return d.to(x.dtype), m_new, v_new

        outs = tree_map(block, updates, state.mu, state.nu, params,
                        tree_paths(params))
        pick = lambda i: tree_map(lambda o: o[i], outs)
        return pick(0), AdamWState(count=t, mu=pick(1), nu=pick(2))

    return GradientTransformation(init_fn, update_fn)


def adamw(learning_rate, **kw) -> GradientTransformation:
    return chain(scale_by_adamw(**kw),
                 scale_by_schedule(as_schedule(learning_rate)))


def bn_adamw(learning_rate, **kw) -> GradientTransformation:
    """The paper's finetuning optimizer: AdamW + blockwise grad
    normalization."""
    kw.setdefault("block_normalize", True)
    return adamw(learning_rate, **kw)


# --------------------------------------------------------------------------
# SGD with classic momentum (eqs. 2-3) and Nesterov momentum (paper §2.2)
# --------------------------------------------------------------------------

class MomentumState(NamedTuple):
    momentum: Any   # fp32


def scale_by_momentum(mu: float = 0.9,
                      nesterov: bool = False) -> GradientTransformation:
    def init_fn(params):
        return MomentumState(tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params))

    def update_fn(updates, state, params=None):
        m_new = tree_map(lambda m, g: mu * m + g.float(), state.momentum,
                         updates)
        if nesterov:
            # x_{t+1} = x_t - eta (mu * m_t + g_t): the "future momentum"
            d = tree_map(lambda m, g: mu * m + g.float(), m_new, updates)
        else:
            d = m_new
        return (tree_map(lambda dd, g: dd.to(g.dtype), d, updates),
                MomentumState(m_new))

    return GradientTransformation(init_fn, update_fn)


def sgd(learning_rate, mu: float = 0.0,
        nesterov: bool = False) -> GradientTransformation:
    sched = scale_by_schedule(as_schedule(learning_rate))
    if mu == 0.0:
        return chain(identity(), sched)
    return chain(scale_by_momentum(mu, nesterov), sched)
