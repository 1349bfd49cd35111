"""fused_mixed_lans: the cast-and-apply path as a transform (port of
repro/precision/fused.py).

`mixed_precision(fused_lans(...), policy)` works, but it re-casts the
whole master tree to low precision outside the kernels, an extra full
read and write of the parameters per step. This transform routes every
block through `ops.fused_lans_mixed_step` instead, whose K4 writes the
fp32 master update AND its low-precision cast in one pass: K1, K2 and K4
once per parameter tensor per step.

State layout matches mixed_precision's sparse-master convention; moments
are fp32 because the kernels accumulate into them directly. On a mesh
the kernels run on each rank's shards, as fused_lans does there
(core/optim/fused.py).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core.optim.base import (WeightDecayMask, as_schedule,
                                         tree_consume, tree_device,
                                         tree_items, tree_map, tree_paths)
from repro_torch.core.optim.fused import (mesh_update, on_mesh,
                                          step_scalars)
from repro_torch.kernels import ops
from repro_torch.precision.loss_scale import LossScaleState, all_finite
from repro_torch.precision.mixed import (MixedTransformation,
                                         _merge_master, _stash_master,
                                         _to_master, read_finite)
from repro_torch.precision.policy import Policy, _is_float


class FusedMixedState(NamedTuple):
    loss_scale: LossScaleState
    count: torch.Tensor  # int32 0-d, applied steps
    master: Any          # sparse fp32 masters (placeholder where params fp32)
    mu: Any              # fp32 (kernel contract)
    nu: Any              # fp32


def fused_mixed_lans(learning_rate, policy: Policy, loss_scale=None,
                     beta1: float = 0.9, beta2: float = 0.999,
                     eps: float = 1e-6, weight_decay: float = 0.01,
                     decay_mask: Optional[Callable[[str], bool]] = None
                     ) -> MixedTransformation:
    """Kernel-fused LANS + master weights + loss scaling in one
    transform."""
    ls = loss_scale if loss_scale is not None else policy.make_loss_scale()
    mask_fn = decay_mask or WeightDecayMask()
    sched = as_schedule(learning_rate)

    def init_fn(params):
        dev = tree_device(params)
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return FusedMixedState(
            loss_scale=ls.init(dev),
            count=torch.zeros((), dtype=torch.int32, device=dev),
            master=_stash_master(_to_master(params), params),
            mu=tree_map(zeros, params), nu=tree_map(zeros, params))

    def update_fn(updates, state, params):
        if params is None:
            raise ValueError("fused_mixed_lans requires params.")
        master = _merge_master(state.master, params)
        grads32 = ls.unscale(updates, state.loss_scale)
        finite = all_finite(grads32)
        box = [grads32]            # the only reference: see tree_consume
        del updates, grads32

        def one(g, m, v, x, p, pth):
            # x_lp of the result is the update of the model copy:
            # new copy - copy (for non-float leaves p - p)
            if not _is_float(x):   # non-float leaves pass through
                return ops.MixedStepOut(x, m, v, p - p)
            o = ops.fused_lans_mixed_step(
                g, m, v, x, lp_dtype=policy.leaf_dtype(pth), beta1=beta1,
                beta2=beta2, eps=eps, scalars=rows[pth])
            return o._replace(x_lp=o.x_lp - p)

        # One host read of the finite flag per step, in place of the JAX
        # package's lax.cond: an overflow step launches nothing. On meta
        # tensors (the dry run) there is no flag to read: the finite
        # step is traced.
        ok = finite.device.type == "meta" or read_finite(finite)
        if ok and on_mesh(params):
            new_master, new_mu, new_nu, updates_out = _mesh_update(
                box.pop(), state, master, params)
        elif ok:
            rows = step_scalars(sched(state.count), state.count + 1, params,
                                mask_fn, beta1=beta1, beta2=beta2,
                                lam=weight_decay)
            outs = tree_consume(one, box.pop(), state.mu, state.nu, master,
                                params, tree_paths(params))
            pick = lambda f: tree_map(lambda o: getattr(o, f), outs)
            new_master, new_mu, new_nu, updates_out = (
                pick("x"), pick("m"), pick("v"), pick("x_lp"))
        else:
            # lp params already equal cast(master): re-emit them unchanged
            new_master, new_mu, new_nu = master, state.mu, state.nu
            updates_out = tree_map(lambda p: p - p, params)
        return updates_out, FusedMixedState(
            loss_scale=ls.adjust(state.loss_scale, finite),
            # count advances on applied steps only, as in the generic
            # wrapper: bias correction tracks the number of moment
            # updates, and a skipped step takes no schedule tick
            count=state.count + finite.to(torch.int32),
            master=_stash_master(new_master, params), mu=new_mu, nu=new_nu)

    def _mesh_update(grads, state, master, params):
        """The finite step on a mesh: K1, K2 and K4 on every leaf's
        local shards (core/optim/fused.py: mesh_update). Returns the new
        master, moments and model-copy updates."""
        for pth, p in tree_items(params):
            if not _is_float(p):
                raise TypeError(f"fused_mixed_lans on a mesh takes float "
                                f"leaves only, {pth} is {p.dtype}")

        def run(cuts, reduce, paths):
            rows = ops.lans_scalar_rows(
                sched(state.count), state.count + 1,
                [bool(mask_fn(pth)) for pth in paths], beta1=beta1,
                beta2=beta2, lam=weight_decay,
                device=cuts[0].g.device).unbind(0)
            return ops.sharded_lans_steps(
                [(c.g, c.m, c.v, c.x, row) for c, row in zip(cuts, rows)],
                [c.key for c in cuts], reduce, beta1=beta1, beta2=beta2,
                eps=eps, lp_dtypes=[policy.leaf_dtype(pth) for pth in paths])

        x, m, v, x_lp = mesh_update(grads, state.mu, state.nu, master, run,
                                    lp_like=params)
        return x, m, v, tree_map(torch.sub, x_lp, params)

    return MixedTransformation(init_fn, update_fn)
