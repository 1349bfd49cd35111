"""Kernel-backed LANS: the fused step as a GradientTransformation (port
of repro/core/optim/fused.py).

A drop-in for `lans(...)` that routes every block through the fused
kernels (kernels/ops.py: K1 sq_norm, K2 lans_phase1, K3 lans_phase2),
one launch of each per parameter tensor per step. CUDA params run the
hand-written kernels; CPU params their plain versions. This is the
counterpart of the paper's apex `fused_lans` optimizer.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core.optim.base import (
    GradientTransformation,
    WeightDecayMask,
    tree_device,
    tree_items,
    tree_map,
    tree_paths,
)
from repro_torch.kernels import ops


class FusedState(NamedTuple):
    count: torch.Tensor   # int32 0-d
    mu: Any               # fp32 (kernel contract)
    nu: Any               # fp32


def step_scalars(eta, step, params, mask_fn, *, beta1, beta2, lam):
    """{path: that tensor's row of the step's kernel scalars}, built in
    one go (ops.lans_scalar_rows) rather than once per tensor."""
    paths = [p for p, _ in tree_items(params)]
    rows = ops.lans_scalar_rows(eta, step, [bool(mask_fn(p)) for p in paths],
                                beta1=beta1, beta2=beta2, lam=lam,
                                device=tree_device(params))
    return dict(zip(paths, rows.unbind(0)))


def fused_lans(learning_rate, beta1: float = 0.9, beta2: float = 0.999,
               eps: float = 1e-6, weight_decay: float = 0.01,
               decay_mask: Optional[Callable[[str], bool]] = None
               ) -> GradientTransformation:
    """LANS on the fused kernels; the same maths as `lans(...)` with its
    default switches."""
    mask_fn = decay_mask or WeightDecayMask()
    sched = learning_rate if callable(learning_rate) else (
        lambda count: torch.full((), learning_rate, dtype=torch.float32,
                                 device=count.device))

    def init_fn(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return FusedState(
            count=torch.zeros((), dtype=torch.int32,
                              device=tree_device(params)),
            mu=tree_map(zeros, params), nu=tree_map(zeros, params))

    def update_fn(updates, state, params):
        if params is None:
            raise ValueError("fused optimizers require params")
        t = state.count + 1
        rows = step_scalars(sched(state.count), t, params, mask_fn,
                            beta1=beta1, beta2=beta2, lam=weight_decay)

        def one(g, m, v, x, pth):
            o = ops.fused_lans_step(g, m, v, x, beta1=beta1, beta2=beta2,
                                    eps=eps, scalars=rows[pth])
            # as an additive update, delta = x_new - x, as the reference
            # does: x + (x_new - x) is not always x_new in floating point,
            # and parity depends on taking the same route
            return (o.x - x).to(x.dtype), o.m, o.v

        outs = tree_map(one, updates, state.mu, state.nu, params,
                        tree_paths(params))
        pick = lambda i: tree_map(lambda o: o[i], outs)
        return pick(0), FusedState(count=t, mu=pick(1), nu=pick(2))

    return GradientTransformation(init_fn, update_fn)


def fused_lamb(*args, **kwargs):
    raise NotImplementedError("fused_lamb is not ported yet: the LAMB "
                              "kernels K5-K6 come with the next slice")
