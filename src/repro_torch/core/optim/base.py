"""Gradient-transformation API over nested dicts of tensors (port of
repro/core/optim/base.py).

    tx = chain(scale_by_lans(...), scale_by_schedule(sched))
    state = tx.init(params)
    updates, state = tx.update(grads, state, params)
    params = apply_updates(params, updates)

A tree is a nested dict whose leaves are tensors (or None). Transforms
are plain functions that return new trees and leave their inputs as they
were, as the JAX package's pure transforms do. Scalars that change from
step to step (counts, learning rates, bias corrections) are 0-d tensors
on the parameters' device, so a step never reads them back to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

Tree = Any
Schedule = Callable[[torch.Tensor], torch.Tensor]


# --------------------------------------------------------------------------
# trees: nested dicts, leaves in the JAX package's order (sorted keys)
# --------------------------------------------------------------------------

def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` and the matching leaves of `rest`."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_consume(fn, tree, *rest):
    """tree_map over a COPY of `tree`'s dicts that gives each leaf up once
    fn has run on it: where nothing else holds the leaves, each is freed
    as soon as it has been used, which at full size keeps an update's
    peak one tree lower. The train step hands the transform its only
    reference to the gradients, and a transform passes it on as
    `tree_consume(fn, box.pop(), ...)` from a one-item list that held it.
    A caller that keeps its own reference gets its tree back whole."""
    work = [tree_map(lambda x: x, tree)]
    del tree
    return _consume(fn, work.pop(), rest)


def _consume(fn, tree, rest):
    # a module-level function, not a closure over itself: a recursive
    # closure is a reference cycle that would keep fn, and what fn holds
    # (an optimizer's old state), alive until the collector runs
    out = {}
    for k in list(tree):
        v = tree.pop(k)
        rs = [r[k] for r in rest]
        out[k] = (_consume(fn, v, rs) if isinstance(v, dict)
                  else fn(v, *rs))
        del v, rs
    return out


def tree_items(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs, paths '/'-joined and in sorted-key order, the
    order in which the JAX package flattens a dict."""
    out = []
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else str(k)
        v = tree[k]
        out.extend(tree_items(v, path) if isinstance(v, dict)
                   else [(path, v)])
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_items(tree)]


def tree_paths(tree):
    """Tree of '/'-joined key paths, same structure as `tree`."""
    def walk(t, prefix):
        return {k: walk(v, f"{prefix}/{k}" if prefix else str(k))
                if isinstance(v, dict) else (f"{prefix}/{k}" if prefix
                                             else str(k))
                for k, v in t.items()}
    return walk(tree, "")


# --------------------------------------------------------------------------
# transforms
# --------------------------------------------------------------------------

class GradientTransformation(NamedTuple):
    """A pair of functions (init, update)."""

    init: Callable[[Tree], Any]
    # update(grads, state, params) -> (updates, new_state)
    update: Callable[[Tree, Any, Optional[Tree]], tuple]


class EmptyState(NamedTuple):
    pass


class ScaleState(NamedTuple):
    pass


class ScaleByScheduleState(NamedTuple):
    count: torch.Tensor  # int32 0-d


def tree_device(tree) -> torch.device:
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def identity() -> GradientTransformation:
    """Pass the updates through unchanged."""
    return GradientTransformation(lambda params: EmptyState(),
                                  lambda updates, state, params=None:
                                  (updates, state))


def scale(step_size: float) -> GradientTransformation:
    """Multiply the updates by a constant."""

    def update_fn(updates, state, params=None):
        return tree_map(lambda u: step_size * u, updates), state

    return GradientTransformation(lambda params: ScaleState(), update_fn)


def as_schedule(learning_rate) -> Schedule:
    """A schedule as it is, or a constant learning rate as one (a 0-d fp32
    tensor on the count's device)."""
    if callable(learning_rate):
        return learning_rate
    return lambda count: torch.full((), learning_rate, dtype=torch.float32,
                                    device=count.device)


def scale_by_schedule(schedule: Schedule) -> GradientTransformation:
    """Multiply updates by -schedule(count); increments count each step."""

    def init_fn(params):
        return ScaleByScheduleState(count=torch.zeros(
            (), dtype=torch.int32, device=tree_device(params)))

    def update_fn(updates, state, params=None):
        lr = schedule(state.count)
        # -lr * u in the promoted type, as JAX promotes bf16 x f32 to f32
        box = [updates]           # the only reference: see tree_consume
        del updates
        updates = tree_consume(
            lambda u: -lr * u.to(torch.promote_types(u.dtype, lr.dtype)),
            box.pop())
        return updates, ScaleByScheduleState(count=state.count + 1)

    return GradientTransformation(init_fn, update_fn)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init_fn(params):
        return tuple(t.init(params) for t in transforms)

    def update_fn(updates, state, params=None):
        # hold no reference to a stage's input while the next stage runs
        # (see tree_consume)
        box = [updates]
        del updates
        new_state = []
        for t, s in zip(transforms, state):
            res = t.update(box.pop(), s, params)
            box.append(res[0])
            new_state.append(res[1])
            del res
        return box.pop(), tuple(new_state)

    return GradientTransformation(init_fn, update_fn)


def apply_updates(params, updates):
    """params + updates, in each param's dtype (master-weight safe). Each
    update is given up once applied (tree_consume)."""
    box = [updates]               # the only reference: see tree_consume
    del updates
    return tree_consume(lambda u, p: p if u is None else p + u.to(p.dtype),
                        box.pop(), params)


# --------------------------------------------------------------------------
# numeric helpers of the optimizers
# --------------------------------------------------------------------------

def tree_zeros_like(params, dtype=None):
    """Zeros shaped like each leaf, in `dtype` or the leaf's own."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=dtype or p.dtype),
                    params)


def safe_norm(x: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """l2 norm in fp32; returns max(norm, eps)."""
    x = x.float()
    return torch.clamp(torch.sqrt(torch.sum(x * x)), min=eps)


def safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num/den with den == 0 (or NaN) -> 0: a zero block normalizes to 0."""
    return torch.where(den > 0.0, num / torch.clamp(den, min=1e-38),
                       torch.zeros_like(num))


def bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    """1 - decay**t in fp32 for a (1-indexed) step count (a 0-d tensor).
    fp32 on purpose: 1 - decay**t in fp64 on the host differs at 1e-7
    relative."""
    count = torch.as_tensor(count)
    base = torch.full((), decay, dtype=torch.float32, device=count.device)
    return 1.0 - torch.pow(base, count.to(torch.float32))


@dataclasses.dataclass(frozen=True)
class WeightDecayMask:
    """Predicate over tree paths selecting params that receive weight decay.

    The paper (following BERT/LAMB practice) excludes LayerNorm scales and
    biases from decay and from the trust-ratio rescaling (phi == 1 for them).
    Copied verbatim from the JAX package, faults included: BERT's
    LayerNorm scales sit at paths like "layers/attn_ln/scale", which match
    none of these substrings, so they DO get decay and trust scaling
    there (ROADMAP Queue 3).
    """

    exclude_substrings: Sequence[str] = ("bias", "layernorm", "ln_", "norm",
                                         "scale_param")

    def __call__(self, path: str) -> bool:
        lowered = path.lower()
        return not any(s in lowered for s in self.exclude_substrings)
