"""Train and serve step builders (port of repro/distributed/steps.py:
build_train_step, on one device or on a mesh, with place_train_step in
the place of jit_train_step; build_prefill_step, build_serve_step,
build_verify_step and greedy_next, on one device or on a serving mesh).

PyTorch runs eagerly, so where the JAX package jitted a step the port
returns a plain function. The serving cache (arenas, tables, cursors) is
written in place by the serve step; the train step returns new params
and optimizer state and leaves its inputs as they were.

Gradient accumulation: `microbatches > 1` splits the batch on its
leading dim and averages the gradients in fp32 (the JAX package's
lax.scan over microbatch slices).

Mixed precision: pass `policy` ("bf16", "fp16_mixed", ...) and the raw
optimizer; the builder wraps it with `mixed_precision` (fp32 master
weights), scales the loss by the loss scale carried in the optimizer
state before the backward pass, and the metrics gain `loss_scale`,
`overflow_count` and `grads_finite`. An optimizer that already carries
a loss scale (precision.fused_mixed_lans) is used as it is: the JAX
builder wraps it again, and that outer wrapper then adds
`cast(new master) - master` to its own master, which leaves the master
rounded to the low-precision copy on every step (ROADMAP Queue 3).

On a mesh (`mesh=` a DeviceMesh with axes ("data", "model") or ("pod",
"data", "model"), launch/mesh.py) params and optimizer state are
DTensors placed by the sharding rules (distributed/sharding.py), and
every rank is handed the same global batch, as JAX feeds one. A step
runs the loss on the rank's block of each microbatch as cut by
batch_pspec, with the losses' means taken over the whole microbatch
(models/common.py: WHOLE), and hands the models the rank's shards, each
cut leaf marked with its use plan (sharding.use_plan), under the ambient
mesh (models/common.py: ambient_mesh). A rank holds only its shards
between uses:
- a leaf cut over "model" on whole heads or ff columns is used as its
  shard in a column- or row-parallel matmul, so that the model axis
  cuts the compute too (one all-reduce of the activations per block);
  attention whose heads the model size does not divide is computed in
  head groups: wq / wk / wv gathered over the rank's group alone, wo
  on the rank's rows (sharding.use_plan: "heads");
  so are MoE expert stacks (each rank its experts, or every expert's
  ff columns: models/moe.py), a vocab-cut embedding and lm_head (the
  lookup, the readout and the cross entropy on each rank's vocab rows:
  models/common.py) and a Mamba-2 mixer cut on whole heads (its
  in_proj and conv_w exchanged into the rank's heads' columns at use:
  models/mamba2.py);
- every other cut leaf is gathered at its use, one layer at a time,
  inside the layer's recomputed region, so that the backward pass
  gathers it again rather than keeping it whole;
- the gradient of a leaf cut over a data axis (zero3) is reduce-scattered
  in the backward pass of its gather, once per microbatch;
- the gradient of any other leaf (replicated, or cut over "model" only)
  is the rank's part, summed over the data ranks after the backward
  pass: an all-reduce, of the whole leaf for a replicated one, as
  before the model axis was split, of the shard for the others.
The gradients then come back as shards and are wrapped as DTensors at
the params' placements. The optimizer updates the placed leaves; the
fused ones run their kernels on each rank's shards
(core/optim/fused.py). MoE routes each rank's block as one group
(models/moe.py). Splitting a matmul over "model" changes the order of
its sums: the model ranks' parts are added in fp32 at least and in rank
order (distributed/partial.py), so that a run gives the same bits
whatever the backend, and one device that splits its matmuls alike
(the tests' mesh-order reference) gives them too.

Serving on a mesh runs one process per rank, each with the same engine
loop (serving/engine.py). The steps take the engine's whole (max_batch,
...) tokens, positions and sampler keys on every rank, and a rank's
pool cache (its slots' rows, its share of each arena, its KV heads:
distributed/sharding.py: ServeLayout). A serve or verify step decodes
the rank's own rows (ServeLayout.local_rows) and gathers the picks over
"data", so that every rank returns every slot's token; a prefill step
runs the admitted group whole on every rank. The models see the model
axis alone (serving_ambient): the params' leaves that serve_params cut
(distributed/sharding.py) then compute the rank's part, as in training:
its heads and ff columns, its experts (MoE routes each call's batch as
one group, as one device does), its vocab rows and its Mamba heads.
Where the vocab is cut, the logits are the rank's columns and every
pick is taken over "model" (serving/sampler.py: VocabCut), and so is
each step's non-finite flag.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.core.optim.base import apply_updates, tree_leaves, tree_map
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.partial import sum_over, whole
from repro_torch.launch import trace_cost
from repro_torch.metrics.spans import count, span
from repro_torch.models.common import WHOLE, Ambient, ambient_mesh


def greedy_next(logits, cut=None):
    """(B, 1, V) -> (B,) int32 greedy pick; of a rank's vocab-parallel
    columns (cut: serving/sampler.py: VocabCut), the whole row's."""
    from repro_torch.serving.sampler import greedy
    return greedy(logits[:, -1, :], cut)


class _ModelAxis:
    """The model axis of a serving mesh alone, as the models' ambient
    mesh: sizes {"model": M}, and its process group."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.shape = {"model": shd.mesh_shape(mesh).get("model", 1)}

    def get_group(self, name):
        return self.mesh.get_group(name)


def serving_ambient(mesh):
    """The ambient mesh of a serving call on `mesh` (nothing off a
    mesh): the model axis only, so that tensor-parallel leaves find
    their group while each call's batch stays whole to the models (an
    MoE layer routes it as one group; models/moe.py)."""
    if mesh is None:
        return contextlib.nullcontext()
    return ambient_mesh(Ambient(_ModelAxis(mesh)))


def gather_slots(picks, layout, mesh, flag=None):
    """Every slot's picks: this rank's block (its first `block` rows)
    gathered over "data" in rank order. With `flag` (a 0-d count of this
    rank's), returns (picks, the data ranks' flags summed), the flags
    riding in the same gather."""
    picks = picks[:layout.block].contiguous()
    if layout.data == 1:
        return picks if flag is None else (picks, flag)
    from repro_torch.distributed.partial import all_gather_dim
    group = mesh.get_group("data")
    if flag is None:
        return all_gather_dim(picks, 0, group)
    row = torch.cat([picks.reshape(1, -1),
                     flag.to(picks.dtype).reshape(1, 1)], dim=1)
    rows = all_gather_dim(row, 0, group)
    return rows[:, :-1].reshape(-1, *picks.shape[1:]), rows[:, -1].sum()


def shared_clock(mesh, device):
    """time.perf_counter off a mesh. On one, a clock that reads rank 0's
    time.perf_counter on every rank (a broadcast over the world group, so
    every rank calls it at the same points of the same loop): the
    serving decisions that read a clock (SLO eviction, the deadline
    policy's order, an open-loop driver's arrivals) then come out alike
    everywhere."""
    if mesh is None:
        return time.perf_counter
    dev = (torch.device(device) if dist.get_backend() == "nccl"
           else torch.device("cpu"))

    def clock():
        t = torch.tensor([time.perf_counter()], dtype=torch.float64,
                         device=dev)
        dist.broadcast(t, src=0)
        return float(t)
    return clock


def _counted(step, mesh, layout, nonfinite):
    """A serve or verify step (-> picks, cache, its logits' non-finite
    flag) as the builders return it: (picks, cache), every slot's picks
    on a mesh, and `nonfinite` (a 0-d int64 tensor, None: no count)
    raised by one for a step whose logits held a NaN or inf on any data
    rank."""
    def count(bad):
        if nonfinite is not None:
            nonfinite.add_(bad > 0)

    if mesh is None:
        def one_step(*args):
            out, new_cache, bad = step(*args)
            count(bad)
            return out, new_cache
        return one_step

    def mesh_step(params, tokens, positions, cache, keys=None):
        with serving_ambient(mesh):
            out, new_cache, bad = step(
                params, layout.local_rows(tokens),
                layout.local_rows(positions, -1), cache,
                None if keys is None else layout.local_rows(keys))
        out, bad = gather_slots(out, layout, mesh, flag=bad)
        count(bad)
        return out, new_cache
    return mesh_step


def build_prefill_step(prefill_fn: Callable, mesh=None):
    """prefill_fn(...) -> (logits, cache), run under the serving mesh's
    ambient (serving_ambient): on every rank the whole admitted group,
    its padding and row count one device's, so that a data mesh's
    prompt K/V and first tokens are one device's bits; a model axis
    computes each rank's heads (the cache holds them). Off a mesh,
    prefill_fn itself."""
    if mesh is None:
        return prefill_fn

    def prefill(*args, **kw):
        with serving_ambient(mesh):
            return prefill_fn(*args, **kw)
    return prefill


def build_serve_step(decode_fn: Callable, mesh=None, *, sampler=None,
                     layout=None, nonfinite=None, vocab=None):
    """decode_fn(params, batch, cache) -> (logits, cache), e.g.
    Arch.decode_step. Returns

        step(params, tokens (B, 1), positions (B, 1), cache)
            -> (next_tokens (B,) int32, cache)

    or, with a non-greedy `sampler` (serving.sampler.Sampler),

        step(params, tokens, positions, cache, keys (B, 2) uint32)
            -> (next_tokens (B,) int32, cache)

    picking tokens from fp32 logits whatever the serving precision.

    On a mesh (with its ServeLayout `layout`) the step takes every
    slot's tokens, positions and keys and the rank's cache, decodes the
    rank's rows and returns every slot's picks (the module docstring);
    where the model axis cuts the vocab, `vocab` (serving/sampler.py:
    VocabCut) describes the rank's logit columns, and the picks are the
    whole rows'. `nonfinite` (a 0-d int64 device tensor) gains one for
    each step whose logits hold a NaN or inf, in any slot of any data
    rank and in any model rank's columns."""
    from repro_torch.serving.sampler import nonfinite as not_finite
    pick = _picker(sampler, vocab)

    @torch.no_grad()
    def step(params, tokens, positions, cache, keys=None):
        logits, new_cache = decode_fn(
            params, {"tokens": tokens, "positions": positions}, cache)
        return (pick(logits[:, -1, :].float(), keys), new_cache,
                not_finite(logits, vocab))

    return _counted(step, mesh, layout, nonfinite)


def build_verify_step(decode_fn: Callable, mesh=None, *, sampler=None,
                      layout=None, nonfinite=None, vocab=None):
    """The speculative verify step: K tokens per slot in one forward.

    decode_fn(params, batch, cache) -> (logits (B, K, V), cache). Returns

        step(params, tokens (B, K), positions (B, K), cache)
            -> (tokens (B, K) int32, cache)

    or, with a non-greedy sampler, step(..., cache, keys (B, K, 2)
    uint32). Row (b, i) is the target's pick for the position after
    positions[b, i], made exactly as build_serve_step makes its single
    row (fp32 logits, the row's own key), so a speculative stream equals
    the non-speculative one token for token. On a mesh, `vocab` and
    `nonfinite`, as build_serve_step's."""
    from repro_torch.serving.sampler import nonfinite as not_finite
    pick = _picker(sampler, vocab)

    @torch.no_grad()
    def step(params, tokens, positions, cache, keys=None):
        logits, new_cache = decode_fn(
            params, {"tokens": tokens, "positions": positions}, cache)
        B, K, V = logits.shape
        flat_keys = None if keys is None else keys.reshape(B * K, 2)
        out = pick(logits.reshape(B * K, V).float(), flat_keys)
        return out.reshape(B, K), new_cache, not_finite(logits, vocab)

    return _counted(step, mesh, layout, nonfinite)


def _picker(sampler, cut=None):
    """(fp32 logits (N, V), keys (N, 2) or None) -> (N,) int32: the
    sampler's pick (greedy, tie-stable greedy or sampled), argmax without
    one; of a rank's vocab-parallel columns (cut), the whole row's."""
    from repro_torch.serving.sampler import greedy
    if sampler is not None:
        return lambda logits, keys: sampler.sample(logits, keys, cut)
    return lambda logits, keys: greedy(logits, cut)


def loss_and_grads(loss_fn, params, batch, scale):
    """(loss, aux, fp32 grads) of one (micro)batch; the loss is multiplied
    by `scale` (after its fp32 reduction) before the backward pass."""
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    leaves = tree_leaves(live)
    with torch.enable_grad():
        with span("train.forward"):
            loss, aux = loss_fn(live, batch)
            objective = (loss if scale is None
                         else loss * scale.to(loss.dtype))
        with span("train.backward"):
            grads = torch.autograd.grad(objective, leaves,
                                        allow_unused=True)
    by_leaf = {id(t): (torch.zeros(t.shape, dtype=torch.float32,
                                   device=t.device) if g is None
                       else g.float())
               for t, g in zip(leaves, grads)}
    aux = {k: v.detach() if torch.is_tensor(v) else v
           for k, v in aux.items()}
    return loss.detach(), aux, tree_map(lambda t: by_leaf[id(t)], live)


def build_train_step(loss_fn: Callable, tx, mesh=None, *,
                     microbatches: int = 1, zero3: bool = False,
                     zero1: bool = False,
                     param_init_fn: Optional[Callable] = None, policy=None,
                     loss_scale=None, heads: Optional[tuple] = None,
                     mamba=None):
    """Returns (step_fn, init_fn), on one device or, with `mesh`, on it.

    step_fn: (params, opt_state, batch) -> (params, opt_state, metrics)
    init_fn: torch.Generator -> (params, opt_state)

    loss_fn(params, batch) -> (loss, aux dict); batch is a dict of
    tensors whose leading dim is the batch. With a policy that needs
    master weights or loss scaling, `tx` is wrapped in mixed_precision
    unless it is a mixed-precision transform already
    (precision.fused_mixed_lans).

    With a mesh, step_fn takes placed params and state (DTensors) and
    the whole global batch, and `step_fn.specs_for(params_like,
    opt_like) -> (params_pspec, opt_pspec)` gives the specs to place
    them by (zero3 adds the data axis to the weights' specs);
    place_train_step does the placing. `heads`, the (n_heads, n_kv,
    head_dim) of the model's attention (Arch.heads), is required with a
    mesh: the step splits attention over "model" on whole heads where
    the model size divides both head counts, else in head groups
    wherever the rules cut its four kernels (sharding.head_groups).
    `mamba`, the Mamba-2 mixer's config (Arch.mamba), lets
    it split a Mamba mixer on whole heads too; without it the mixer's
    projections are gathered.
    """
    if mesh is not None and heads is None:
        raise ValueError("build_train_step on a mesh needs heads= "
                         "(Arch.heads)")
    if mesh is not None:
        # the head groups' process groups, made once by every rank here
        # rather than at a first use inside a step
        msize = shd.mesh_shape(mesh).get("model", 1)
        d = shd.head_groups(heads, msize)
        if 1 < d < msize:
            shd.head_group(mesh, d)
    zero1 = zero1 and not zero3
    from repro_torch import precision
    if policy is not None:
        policy = precision.get_policy(policy)
    mixed = policy is not None and policy.wants_wrapper
    if mixed and not isinstance(tx, precision.MixedTransformation):
        tx = precision.mixed_precision(tx, policy, loss_scale)

    def accumulate(params, batch, scale, local, fn=loss_fn):
        """(loss, aux, fp32 grads) of `fn` over the microbatches of
        `batch`, each cut to this rank's block by `local` before the loss
        sees it."""
        if microbatches == 1:
            return loss_and_grads(fn, params, local(batch), scale)
        n = next(iter(batch.values())).shape[0]
        if n % microbatches:
            raise ValueError(f"batch {n} does not split into "
                             f"{microbatches} microbatches")
        size = n // microbatches
        # float aux averaged over the whole batch, other aux from the
        # last microbatch (as the JAX package does)
        summed = lambda v: torch.is_tensor(v) and v.is_floating_point()
        grads = loss = aux = None
        # every trip after the first has the same work: a tracer that
        # folds loops runs two trips (launch/trace_cost.py: loop)
        for i in trace_cost.loop(microbatches):
            mb = {k: v[i * size:(i + 1) * size] if v.ndim >= 1 else v
                  for k, v in batch.items()}
            loss_i, aux_i, g_i = loss_and_grads(fn, params, local(mb),
                                                scale)
            if grads is None:
                grads, loss, aux = g_i, loss_i, aux_i
                continue
            grads = tree_map(torch.add, grads, g_i)
            loss = loss + loss_i
            aux = {k: aux[k] + v if summed(v) else v
                   for k, v in aux_i.items()}
        grads = tree_map(lambda g: g / microbatches, grads)
        aux = {k: v / microbatches if summed(v) else v
               for k, v in aux.items()}
        return loss / microbatches, aux, grads

    def update(params, opt_state, loss, aux, grads, scale):
        with torch.no_grad(), span("train.update"):
            gnorm = torch.sqrt(sum(whole(torch.sum(g * g))
                                   for g in tree_leaves(grads)))
            metrics = {"loss": loss, "grad_norm": gnorm, **aux}
            if mixed:
                metrics["grad_norm"] = gnorm / scale   # report unscaled
                metrics["grads_finite"] = precision.all_finite(grads)
            # the transform gets the only reference to the gradients and
            # the update applies the only reference to the updates, so
            # that each leaf is freed once used (core/optim/base.py:
            # tree_consume): a full-size step then peaks at the old and
            # new params and state, without a whole gradient or update
            # tree beside them
            box = [grads]
            del grads
            updates, new_opt = tx.update(box.pop(), opt_state, params)
            box.append(updates)
            del updates
            new_params = apply_updates(params, box.pop())
            if mixed:
                metrics["loss_scale"] = precision.loss_scale_value(new_opt)
                metrics["overflow_count"] = precision.overflow_count(new_opt)
        return new_params, new_opt, metrics

    def step_fn(params, opt_state, batch):
        count("train.steps")
        with span("train.step"):
            scale = (precision.loss_scale_value(opt_state) if mixed
                     else None)
            loss, aux, grads = accumulate(params, batch, scale, lambda b: b)
            box = [grads]
            del grads
            return update(params, opt_state, loss, aux, box.pop(), scale)

    def mesh_step_fn(params, opt_state, batch, bspec=None):
        count("train.steps")
        with span("train.step"):
            return _mesh_step(params, opt_state, batch, bspec)

    def _mesh_step(params, opt_state, batch, bspec):
        scale = precision.loss_scale_value(opt_state) if mixed else None
        bspec = bspec if bspec is not None else shd.batch_pspec(batch, mesh)
        cut = _batch_cut_dims(bspec)
        groups = [mesh.get_group(name) for name in cut]
        # this rank's block of b, which carries b whole for the losses'
        # means (models/common.py: WHOLE)
        local = lambda b: {**{k: shd.local_shard(
            v, mesh, shd.placements(bspec[k], mesh)) if v.ndim else v
            for k, v in b.items()}, WHOLE: b}
        uses = shd.params_uses(params, mesh, heads, mamba)

        def on_shards(live, b):
            # the live leaves carry their use plans to the models' fetch
            tree_map(_mark, live, uses)
            return loss_fn(live, b)

        ctx = Ambient(mesh, cut)
        with ambient_mesh(ctx):
            loss, aux, grads = accumulate(tree_map(_shard, params), batch,
                                          scale, local, on_shards)
        # each rank's loss, float aux and gradients are its parts of the
        # global batch's: sum them over the ranks the batch is cut over
        loss = sum_over(loss, groups)
        aux = {k: sum_over(v, groups) if torch.is_tensor(v)
               and v.is_floating_point() else v for k, v in aux.items()}
        if not zero1:
            grads = tree_map(lambda g, p, u: _placed_grad(
                g, p, u, mesh, cut), grads, params, uses)
            box = [grads]
            del grads
            return update(params, opt_state, loss, aux, box.pop(), scale)
        # ZeRO-1: the gradients reduce-scattered to the moments' cut, the
        # update on the rank's shards, the new weights gathered whole
        mspec = shd.params_pspec(params, mesh, zero3=True)
        grads = tree_map(lambda g, p, u, ms: _placed_grad(
            g, p, u, mesh, cut, shd.placements(ms, mesh)), grads, params,
            uses, mspec)
        shards = tree_map(lambda p, ms: _redistribute(
            p, mesh, shd.placements(ms, mesh)), params, mspec)
        box = [grads]
        del grads
        new_params, new_opt, metrics = update(shards, opt_state, loss, aux,
                                              box.pop(), scale)
        new_params = tree_map(lambda q, p: _redistribute(
            q, mesh, getattr(p, "placements", None)), new_params, params)
        return new_params, new_opt, metrics

    def init_fn(gen: torch.Generator):
        if param_init_fn is None:
            raise ValueError("build_train_step needs param_init_fn for "
                             "init_fn")
        params = param_init_fn(gen)
        if policy is not None:
            params = policy.cast_params(params)
        return params, tx.init(params)

    if mesh is None:
        return step_fn, init_fn

    def specs_for(params_like, opt_like):
        pspec = shd.params_pspec(params_like, mesh, zero3=zero3)
        mspec = (shd.params_pspec(params_like, mesh, zero3=True) if zero1
                 else None)
        return pspec, shd.opt_state_pspec(opt_like, pspec,
                                          moments_spec=mspec)

    mesh_step_fn.specs_for = specs_for
    return mesh_step_fn, init_fn


def _batch_cut_dims(bspec) -> tuple:
    """The mesh dims the batch's leading dim is cut over (every input
    must be cut alike)."""
    firsts = {tuple(s[0]) if isinstance(s[0], tuple) else
              () if s[0] is None else (s[0],)
              for s in bspec.values() if len(s)}
    if len(firsts) > 1:
        raise ValueError(f"batch inputs are cut differently: {bspec}")
    return firsts.pop() if firsts else ()


def _shard(p):
    """The rank's shard of a placed leaf (a plain leaf as it is)."""
    from torch.distributed.tensor import DTensor
    return p.to_local() if isinstance(p, DTensor) else p


def _mark(t, use):
    if use is not None:
        t._use = use


def _redistribute(t, mesh, places):
    """A DTensor at `places` (None: as it is); a plain leaf as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor) or places is None \
            or tuple(t.placements) == tuple(places):
        return t
    return t.redistribute(mesh, places)


def _placed_grad(g, p, use, mesh, cut, target=None):
    """A rank's gradient of its shard of p as a DTensor at p's
    placements, or at `target` (ZeRO-1: the moments' cut over the data
    axes). The data dims of `cut` (the batch's) that the backward pass
    has not summed it over (all but the leaf's own data cuts, which its
    gather reduce-scattered) are summed here: for a leaf with no cut
    (use None), the whole leaf's gradient, by the all-reduce of a
    Partial DTensor; to a `target` cut over a data dim, by its
    reduce-scatter."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(p, DTensor):
        return sum_over(g, [mesh.get_group(name) for name in cut])
    if target is not None and tuple(target) != tuple(p.placements):
        summed = set() if use is None else {a for a, _ in use.cuts}
        places = [Partial() if name in cut and name not in summed
                  else pl for name, pl in zip(mesh.mesh_dim_names,
                                              p.placements)]
        return DTensor.from_local(g, mesh, places,
                                  run_check=False).redistribute(
            mesh, target)
    if use is None:
        places = [Partial() if name in cut else Replicate()
                  for name in mesh.mesh_dim_names]
        return DTensor.from_local(g, mesh, places,
                                  run_check=False).redistribute(
            mesh, p.placements)
    summed = {a for a, _ in use.cuts}
    for name in cut:
        if name not in summed:
            dist.all_reduce(g, group=mesh.get_group(name))
    return DTensor.from_local(g, mesh, p.placements, run_check=False)


def place_train_step(step_fn, mesh, pspec, ospec, batch_like):
    """The counterpart of the JAX package's jit_train_step, without a
    jit: the returned step places params and optimizer state on `mesh`
    by `pspec` and `ospec` (shd.distribute: plain tensors are cut, placed
    ones redistributed if they differ), cuts the global batch by
    batch_pspec(batch_like), runs `step_fn` (built with this mesh) and
    returns its outputs at those placements."""
    bspec = shd.batch_pspec(batch_like, mesh)

    def step(params, opt_state, batch):
        params, opt_state, metrics = step_fn(
            shd.distribute(params, mesh, pspec),
            shd.distribute(opt_state, mesh, ospec), batch, bspec=bspec)
        return (shd.distribute(params, mesh, pspec),
                shd.distribute(opt_state, mesh, ospec), metrics)

    return step
