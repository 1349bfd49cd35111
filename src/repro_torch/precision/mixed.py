"""mixed_precision(): fp32 master weights around any GradientTransformation
(port of repro/precision/mixed.py).

The model holds low-precision params (policy.cast_params of the master);
the wrapper owns the fp32 master copy and runs the inner optimizer on it:

    tx = mixed_precision(lans(sched, mu_dtype=policy.moment_dtype), policy)
    state = tx.init(lp_params)                  # builds master + inner state
    updates, state = tx.update(scaled_grads, state, lp_params)
    lp_params = apply_updates(lp_params, updates)

Semantics per update (apex O2):
  1. unscale grads to fp32 (divide by the carried loss scale),
  2. check finiteness; on overflow the inner optimizer is skipped —
     master, moments and the low-precision params stay exactly as they
     were, and the scale is halved,
  3. otherwise the inner tx steps the MASTER weights in fp32 and the new
     low-precision copy is re-cast from the master.

Where the JAX package chooses with lax.cond on the device, the port reads
the finite flag on the host, once per step, and skips the inner update
in Python.

Master storage is sparse: leaves the policy keeps fp32 (LayerNorm/bias)
ARE their own master, so the wrapper stores a zero-size placeholder for
them.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core.optim.base import (GradientTransformation,
                                         apply_updates, tree_device, tree_map)
from repro_torch.metrics.spans import count, span
from repro_torch.precision.loss_scale import LossScaleState, all_finite
from repro_torch.precision.policy import Policy, _is_float


class MixedTransformation(GradientTransformation):
    """A GradientTransformation that owns master weights and a loss
    scale (mixed_precision, fused_mixed_lans): build_train_step uses it
    as it is instead of wrapping it again."""


class MixedPrecisionState(NamedTuple):
    loss_scale: LossScaleState
    master: Any  # fp32 masters; zero-size placeholder where params are fp32
    inner: Any   # inner optimizer state, built over the fp32 master tree


def _needs_master(p) -> bool:
    return _is_float(p) and p.dtype != torch.float32


def _stash_master(master, params):
    """Keep master only where the model copy is low precision."""
    return tree_map(lambda m, p: m if _needs_master(p) else torch.zeros(
        (0,), dtype=torch.float32, device=p.device), master, params)


def _merge_master(stored, params):
    """The full master from sparse storage + the fp32 leaves of params
    (bit-identical to their master by construction)."""
    return tree_map(lambda s, p: s if s.numel() != 0 else
                    (p.float() if _is_float(p) else p), stored, params)


def _to_master(params):
    return tree_map(lambda p: p.float() if _is_float(p) else p, params)


def read_finite(finite: torch.Tensor) -> bool:
    """The finite flag read on the host: the step waits for the device
    here (span and counter "sync.finite_flag"; a false read also counts
    "optim.skipped_steps": metrics/spans.py)."""
    with span("sync.finite_flag"):
        ok = bool(finite)
    count("sync.finite_flag")
    if not ok:
        count("optim.skipped_steps")
    return ok


def mixed_precision(tx: GradientTransformation, policy: Policy,
                    loss_scale=None) -> MixedTransformation:
    """Wrap `tx` with master weights + loss scaling per `policy`.

    `loss_scale` defaults to the policy's scaler (dynamic for fp16_mixed,
    static 1.0 for bf16). Incoming grads are expected SCALED (the train
    step multiplies the loss by the carried scale); the wrapper unscales
    in fp32.
    """
    ls = loss_scale if loss_scale is not None else policy.make_loss_scale()

    def init_fn(params):
        master = _to_master(params)
        return MixedPrecisionState(loss_scale=ls.init(tree_device(params)),
                                   master=_stash_master(master, params),
                                   inner=tx.init(master))

    def update_fn(updates, state, params=None):
        if params is None:
            raise ValueError("mixed_precision requires params "
                             "(the low-precision model copy).")
        master = _merge_master(state.master, params)
        grads32 = ls.unscale(updates, state.loss_scale)
        finite = all_finite(grads32)
        # one host read of the flag per step (JAX: lax.cond); on meta
        # tensors (the dry run) the finite step is traced
        if finite.device.type == "meta" or read_finite(finite):
            u32, new_inner = tx.update(grads32, state.inner, master)
            new_master = apply_updates(master, u32)
        else:
            # overflow => skip: master/moments pass through, so the
            # re-cast lp params are exactly unchanged
            new_master, new_inner = master, state.inner
        new_lp = policy.cast_params(new_master)
        updates_out = tree_map(lambda n, p: n - p, new_lp, params)
        return updates_out, MixedPrecisionState(
            loss_scale=ls.adjust(state.loss_scale, finite),
            master=_stash_master(new_master, params), inner=new_inner)

    return MixedTransformation(init_fn, update_fn)


# --------------------------------------------------------------------------
# State introspection: the train step reads the carried scale from inside
# the (possibly nested) optimizer state to scale the loss before the
# grads exist, and logs overflow_count from the post-update state.
# --------------------------------------------------------------------------

def find_loss_scale(opt_state) -> Optional[LossScaleState]:
    """First LossScaleState anywhere in an optimizer state, else None."""
    if isinstance(opt_state, LossScaleState):
        return opt_state
    if isinstance(opt_state, dict):
        children = opt_state.values()
    elif isinstance(opt_state, tuple):
        children = opt_state
    else:
        return None
    for child in children:
        hit = find_loss_scale(child)
        if hit is not None:
            return hit
    return None


def loss_scale_value(opt_state) -> torch.Tensor:
    s = find_loss_scale(opt_state)
    return s.scale if s is not None else torch.ones((), dtype=torch.float32)


def overflow_count(opt_state) -> torch.Tensor:
    s = find_loss_scale(opt_state)
    return (s.overflow_count if s is not None
            else torch.zeros((), dtype=torch.int32))
