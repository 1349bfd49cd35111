"""Kernel-backed LANS and LAMB: the fused steps as GradientTransformations
(port of repro/core/optim/fused.py).

Drop-ins for `lans(...)` and `lamb(...)` that route every block through
the fused kernels of kernels/ops.py, one launch of each per parameter
tensor per step: fused_lans through K1 sq_norm, K2 lans_phase1 and K3
lans_phase2; fused_lamb through K5 lamb_phase1 and K6 lamb_phase2, after
K1 on every gradient for the global clip. CUDA params run the
hand-written kernels; CPU params their plain versions. fused_lans is the
counterpart of the paper's apex `fused_lans` optimizer.

On a mesh (DTensor leaves, distributed/steps.py) the kernels run on each
rank's shard of every leaf, at the moments' placements (under ZeRO-1 the
rank's slice of g and x, taken with no communication), and the new x
goes back to the weight's placements. The per-leaf sums of squares are
added over the ranks a leaf is cut over, one stacked all-reduce per
group of leaves (kernels/ops.py, sharded_*); a whole leaf needs none.
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


class Cut(NamedTuple):
    """A leaf's operands as this rank runs the kernels on them: its local
    shards of g, m, v and x at the moments' placements, and `key`, the
    mesh dims they are cut over (() for a whole leaf)."""
    g: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor
    x: torch.Tensor
    key: tuple
    mesh: Any
    places: tuple


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def on_mesh(tree) -> bool:
    return any(is_dtensor(t) for t in tree_leaves(tree))


def cut_leaf(g, m, v, x) -> Cut:
    """The local shards of one leaf's operands, at m's placements (g and
    x are redistributed there: a slice of what this rank holds when they
    are less sharded, as under ZeRO-1, so nothing is sent)."""
    if not is_dtensor(m):
        return Cut(g, m, v, x, (), None, ())
    mesh, places = m.device_mesh, m.placements
    local = lambda t: t.redistribute(mesh, places).to_local()
    key = tuple(mesh.mesh_dim_names[i] for i, p in enumerate(places)
                if p.is_shard())
    return Cut(local(g), m.to_local(), local(v), local(x), key, mesh, places)


def uncut(c: Cut, local, like):
    """A kernel output's local shard as a DTensor at c's placements,
    redistributed to the placements of `like` (the weight's, for a new
    x); a plain tensor off a mesh."""
    if c.mesh is None:
        return local
    from torch.distributed.tensor import DTensor
    t = DTensor.from_local(local, c.mesh, c.places, run_check=False)
    return t if like is None else t.redistribute(c.mesh, like.placements)


def mesh_reducer(mesh):
    """reduce(stacked, key) for ops.sharded_*: the sum over the ranks of
    the mesh dims named in key."""
    from repro_torch.distributed.partial import reduce_partials
    return lambda t, key: reduce_partials(
        t, [mesh.get_group(name) for name in key])


def _fused(sched, mask_fn, rows_fn, step_fn,
           sharded_fn) -> GradientTransformation:
    """A transform that runs `step_fn(g, m, v, x, row)` (a fused step)
    on every leaf, with the rows `rows_fn(grads, eta, t, params)` builds
    once per step, and returns x_new - x. On a mesh,
    `sharded_fn(cuts, reduce, eta, t, paths)` runs the steps of all the
    leaves' local shards at once."""

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
        if on_mesh(params):
            eta = sched(state.count)
            x_new, mu, nu, _ = mesh_update(
                updates, state.mu, state.nu, params,
                lambda cuts, reduce, paths: sharded_fn(cuts, reduce, eta, t,
                                                       paths))
            upd = tree_map(lambda a, x: (a - x).to(x.dtype), x_new, params)
            return upd, FusedState(count=t, mu=mu, nu=nu)
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


def mesh_update(grads, mu, nu, xs, run, lp_like=None):
    """The mesh path of a fused update: every leaf's g, m, v and x (`xs`,
    the fp32 weights) cut to this rank's shards (cut_leaf), the kernels
    run on all of them by `run(cuts, reduce, paths)` (ops.sharded_*),
    and the outputs put back, as trees like xs: (new x at xs'
    placements, new m, new v, and with `lp_like` the low-precision
    copies at its placements, else None)."""
    items = tree_items(xs)
    paths = [p for p, _ in items]
    flat = lambda tree: dict(tree_items(tree))
    g, m, v = flat(grads), flat(mu), flat(nu)
    del grads
    cuts = [cut_leaf(g.pop(p), m[p], v[p], x) for p, x in items]
    mesh = next(c.mesh for c in cuts if c.mesh is not None)
    outs = run(cuts, mesh_reducer(mesh), paths)
    lp = None if lp_like is None else flat(lp_like)
    res = {"x": {}, "m": {}, "v": {}, "x_lp": {}}
    for (p, x), c, o in zip(items, cuts, outs):
        res["x"][p] = uncut(c, o.x, x)
        res["m"][p], res["v"][p] = uncut(c, o.m, None), uncut(c, o.v, None)
        if lp is not None:
            res["x_lp"][p] = uncut(c, o.x_lp, lp[p])
    like = lambda d: tree_map(lambda pth: d[pth], tree_paths(xs))
    return (like(res["x"]), like(res["m"]), like(res["v"]),
            None if lp is None else like(res["x_lp"]))


def fused_lans(learning_rate, beta1: float = 0.9, beta2: float = 0.999,
               eps: float = 1e-6, weight_decay: float = 0.01,
               decay_mask: Optional[Callable[[str], bool]] = None
               ) -> GradientTransformation:
    """LANS on the fused kernels K1-K3; the same maths as `lans(...)` with
    its default switches."""
    mask_fn = decay_mask or WeightDecayMask()

    def sharded_fn(cuts, reduce, eta, t, paths):
        rows = ops.lans_scalar_rows(
            eta, t, [bool(mask_fn(p)) for p in paths], beta1=beta1,
            beta2=beta2, lam=weight_decay, device=cuts[0].g.device)
        return ops.sharded_lans_steps(
            [(c.g, c.m, c.v, c.x, row) for c, row in zip(cuts,
                                                          rows.unbind(0))],
            [c.key for c in cuts], reduce, beta1=beta1, beta2=beta2,
            eps=eps)

    return _fused(
        as_schedule(learning_rate), mask_fn,
        lambda grads, eta, t, params: step_scalars(
            eta, t, params, mask_fn, beta1=beta1, beta2=beta2,
            lam=weight_decay),
        lambda g, m, v, x, row: ops.fused_lans_step(
            g, m, v, x, beta1=beta1, beta2=beta2, eps=eps, scalars=row),
        sharded_fn)


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

    def sharded_fn(cuts, reduce, eta, t, paths):
        keys = [c.key for c in cuts]
        clip = (1.0 if grad_clip_norm is None else clip_factor(
            sum(ops.sharded_sq_norms([c.g for c in cuts], keys, reduce)),
            grad_clip_norm))
        rows = ops.lamb_scalar_rows(
            eta, t, clip, [bool(mask_fn(p)) for p in paths], beta1=beta1,
            beta2=beta2, lam=weight_decay, device=cuts[0].g.device)
        return ops.sharded_lamb_steps(
            [(c.g, c.m, c.v, c.x, row) for c, row in zip(cuts,
                                                          rows.unbind(0))],
            keys, reduce, beta1=beta1, beta2=beta2, eps=eps)

    return _fused(
        as_schedule(learning_rate), mask_fn, rows_fn,
        lambda g, m, v, x, row: ops.fused_lamb_step(
            g, m, v, x, beta1=beta1, beta2=beta2, eps=eps, scalars=row),
        sharded_fn)
