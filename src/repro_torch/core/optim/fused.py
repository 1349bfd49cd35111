"""Kernel-backed LANS and LAMB: the fused steps as GradientTransformations
(port of repro/core/optim/fused.py).

Drop-ins for `lans(...)` and `lamb(...)` that route every block through
the fused kernels of kernels/ops.py, one launch of each per parameter
tensor per step: fused_lans through K1 sq_norm, K2 lans_phase1 and K3
lans_phase2; fused_lamb through K5 lamb_phase1 and K6 lamb_phase2, after
K1 on every gradient for the global clip. CUDA params run the
hand-written kernels; CPU params their plain versions. fused_lans is the
counterpart of the paper's apex `fused_lans` optimizer.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core.optim.base import (
    GradientTransformation,
    WeightDecayMask,
    as_schedule,
    tree_consume,
    tree_device,
    tree_items,
    tree_leaves,
    tree_map,
    tree_paths,
)
from repro_torch.core.optim.lamb import clip_factor
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


def _fused(sched, mask_fn, rows_fn, step_fn) -> GradientTransformation:
    """A transform that runs `step_fn(g, m, v, x, row)` (a fused step)
    on every leaf, with the rows `rows_fn(grads, eta, t, params)` builds
    once per step, and returns x_new - x."""

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
        rows = rows_fn(updates, sched(state.count), t, params)

        def one(g, m, v, x, pth):
            o = step_fn(g, m, v, x, rows[pth])
            # as an additive update, delta = x_new - x, as the reference
            # does: x + (x_new - x) is not always x_new in floating point,
            # and parity depends on taking the same route
            return (o.x - x).to(x.dtype), o.m, o.v

        box = [updates]           # the only reference: see tree_consume
        del updates
        outs = tree_consume(one, box.pop(), state.mu, state.nu, params,
                            tree_paths(params))
        pick = lambda i: tree_map(lambda o: o[i], outs)
        return pick(0), FusedState(count=t, mu=pick(1), nu=pick(2))

    return GradientTransformation(init_fn, update_fn)


def fused_lans(learning_rate, beta1: float = 0.9, beta2: float = 0.999,
               eps: float = 1e-6, weight_decay: float = 0.01,
               decay_mask: Optional[Callable[[str], bool]] = None
               ) -> GradientTransformation:
    """LANS on the fused kernels K1-K3; the same maths as `lans(...)` with
    its default switches."""
    mask_fn = decay_mask or WeightDecayMask()
    return _fused(
        as_schedule(learning_rate), mask_fn,
        lambda grads, eta, t, params: step_scalars(
            eta, t, params, mask_fn, beta1=beta1, beta2=beta2,
            lam=weight_decay),
        lambda g, m, v, x, row: ops.fused_lans_step(
            g, m, v, x, beta1=beta1, beta2=beta2, eps=eps, scalars=row))


def fused_lamb(learning_rate, beta1: float = 0.9, beta2: float = 0.999,
               eps: float = 1e-6, weight_decay: float = 0.01,
               decay_mask: Optional[Callable[[str], bool]] = None,
               grad_clip_norm: Optional[float] = 1.0
               ) -> GradientTransformation:
    """LAMB on the fused kernels K5-K6; the same maths as `lamb(...)`
    without phi_clip, as the reference. The global clip factor is made on
    the device from K1's per-leaf sums of squares, added in tree order;
    nothing is read back to the host."""
    mask_fn = decay_mask or WeightDecayMask()

    def rows_fn(grads, eta, t, params):
        clip = (1.0 if grad_clip_norm is None else clip_factor(
            sum(ops.block_sq_norm(g) for g in tree_leaves(grads)),
            grad_clip_norm))
        paths = [p for p, _ in tree_items(params)]
        rows = ops.lamb_scalar_rows(
            eta, t, clip, [bool(mask_fn(p)) for p in paths], beta1=beta1,
            beta2=beta2, lam=weight_decay, device=tree_device(params))
        return dict(zip(paths, rows.unbind(0)))

    return _fused(
        as_schedule(learning_rate), mask_fn, rows_fn,
        lambda g, m, v, x, row: ops.fused_lamb_step(
            g, m, v, x, beta1=beta1, beta2=beta2, eps=eps, scalars=row))
