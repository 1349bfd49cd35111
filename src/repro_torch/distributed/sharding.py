"""Partition-spec rules for the production mesh (port of
repro/distributed/sharding.py), and their DTensor placements.

Mesh axes: ("data", "model") single-pod; ("pod", "data", "model") multi-pod.
"pod" is an outer pure-data-parallel axis (the paper's scale-out pattern);
batch dims shard over ("pod", "data") jointly.

Parameter rules (path-keyword driven, rank-aware, with stacked-layer leading
dims skipped automatically):

  embeddings   (V, d)          -> vocab over model
  wq/wk/wv     (d, heads*hd)   -> columns over model
  wo           (heads*hd, d)   -> rows over model
  mlp up/gate  (d, f)          -> columns over model;  down: rows over model
  moe experts  (E, din, dout)  -> experts over model (fallback: ff dim when
                                  E % model_size != 0 — granite's 40, grok's 8)
  mamba in/out projections     -> inner dim over model
  1-D params (biases, norms, A_log, ...) -> replicated

FSDP (zero3=True): additionally shard the largest remaining eligible dim
over "data".

KV caches: (layers, B, L, kv, hd) -> batch over data, head_dim over model.
SSM states: dstate over model. (Serving places its pools by serve_pspec
instead: KV heads and Mamba heads over model, as the steps compute.)

The rules are pure functions of paths, shapes and the mesh's axis sizes,
so a mesh is anything with a `shape` dict ({axis name: size}): a
DeviceMesh through `mesh_shape`, or a shape-only stand-in. A spec is a
`PSpec`, a tuple with one entry per tensor dim: None, an axis name, or a
tuple of axis names (`tuple(jax P) == tuple(PSpec)` for the same rule).
`placements` turns a spec into DTensor placements on a DeviceMesh, and
`distribute` places a tree by a spec tree.

Use plans (the train step on a mesh, distributed/steps.py): `use_plan`
reads from a leaf's spec how the models use it during the step
(models/common.py: fetch). A leaf with no cut is used as it is. A
leaf cut over "model" where the model axis can compute on its shard
keeps that shard, and the rank computes its part:
- "col" / "row": an attention wq / wk / wv or an MLP up / gate kernel
  cut on its columns computes the rank's heads or ff columns; wo or
  down, cut on its rows, the rank's partial product, summed over
  "model". Attention is "col" only where the model size divides both
  n_heads and n_kv (head_groups == model size), so that every rank's
  columns are whole heads of q and of k / v. An MoE expert stack that
  the rule cut on its ff dim (E does not divide) is "col" (up, gate) or
  "row" (down) too: each rank computes every expert's ff columns;
- "heads": attention whose heads the model size does not divide, but
  whose four kernels the rule cuts all the same (the JAX rules cut
  wherever the dim divides, which can split a head: n_kv 1 over two
  ranks, half a head each). The model axis is cut into d =
  head_groups(...) groups of m / d consecutive ranks; the ranks of
  group g hold, side by side, the rule's column chunks of wq / wk / wv
  for the whole q heads [g h / d, (g + 1) h / d) and KV heads [g kv /
  d, (g + 1) kv / d) (GQA's map stays inside a group). The fetch
  gathers a "heads" leaf over its group alone (`groups`: d; its
  gradient reduce-scattered over the group), the rank computes its
  group's heads, and wo stays "row": the rank's m-th of the rows,
  multiplied by the matching columns of its group's output, the
  products summed over all of "model" (each head counted once);
- "expert": an MoE expert stack (E, din, dout) cut on E: the rank runs
  its own experts on the rows routed to them (models/moe.py);
- "vocab": a token embedding (V, d) or an untied lm_head (d, V) cut on
  V: the lookup and the readout work on the rank's rows, and the cross
  entropy on its (..., V / m) logits (models/common.py);
- "mamba": a Mamba-2 mixer's in_proj kernel or conv_w, cut on their
  columns at rest as the JAX rule cuts them (contiguous columns, which
  need not fall on heads), exchanged at use into the rank's own heads'
  columns (`segments`: the cut dim's parts, each split over the ranks
  or whole on every one; distributed/partial.py: exchange); its
  out_proj is "row". Only where the model size divides the mixer's
  heads (and its groups, or there is one group), from the `mamba`
  config the step is given. Serving places them in those columns once,
  at load (serve_params), and marks them without segments: nothing to
  exchange.
Every other cut leaf is gathered whole at its use, one layer at a time:
the router kernel (every rank needs all E logits), a vocab that does
not divide (left whole by the rule), attention whose four kernels the
rule does not all cut.
A leaf also cut over a data axis (zero3) is gathered over that axis in
either case.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.optim.base import tree_map, tree_paths

Tree = Any


class PSpec(tuple):
    """A partition spec: one entry per tensor dim (None, an axis name or a
    tuple of axis names); PSpec() is fully replicated. A one-name tuple
    is kept as the name, as JAX's P keeps it."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self):
        return f"PSpec{tuple.__repr__(self)}"


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a DeviceMesh, or a stand-in's `shape` dict."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _axis_size(mesh, name: str) -> int:
    shape = mesh_shape(mesh)
    return shape[name] if name in shape else 1


def batch_axes(mesh):
    return ("pod", "data") if "pod" in mesh_shape(mesh) else ("data",)


def _divisible(dim: int, size: int) -> bool:
    return size > 1 and dim % size == 0


def param_spec(path: str, shape: tuple, mesh, *, zero3: bool = False,
               n_stack_dims: int = 0) -> PSpec:
    """PartitionSpec for one parameter tensor.

    n_stack_dims: leading stacked-layer dims (periods, layers) left
    unsharded."""
    dsize = _axis_size(mesh, "data")
    low = path.lower()
    core_shape = tuple(shape[n_stack_dims:])
    rank = len(core_shape)
    spec = [None] * rank

    def put(axis_idx: int, name: str) -> bool:
        if spec[axis_idx] is None and _divisible(core_shape[axis_idx],
                                                 _axis_size(mesh, name)):
            spec[axis_idx] = name
            return True
        return False

    if rank >= 2:
        is_expert_stack = rank == 3 and ("up" in low or "down" in low or
                                         "gate" in low)
        if is_expert_stack:
            # (E, din, dout): experts over model, else the ff dim.
            if not put(0, "model"):
                ff_axis = 2 if "up" in low or "gate" in low else 1
                put(ff_axis, "model")
        elif "embed" in low or "lm_head" in low or "mlm" in low:
            # (V, d) embedding tables / (d, V) heads: shard the vocab dim.
            put(int(np.argmax(core_shape)), "model")
        elif any(k in low for k in ("wq", "wk", "wv", "up", "gate", "in_proj",
                                    "router", "pooler", "nsp", "transform")):
            put(rank - 1, "model")            # column parallel
        elif any(k in low for k in ("wo", "down", "out_proj")):
            put(rank - 2, "model")            # row parallel
        else:
            put(int(np.argmax(core_shape)), "model")

        if zero3:
            # FSDP/ZeRO: shard the largest remaining dim over the full
            # data-parallel extent (pod x data when a pod axis exists)
            psize = _axis_size(mesh, "pod")
            candidates = ([("pod", "data"), "data"] if psize > 1
                          else ["data"])
            # stable descending order of sizes, as np.argsort()[::-1]
            order = list(np.argsort(core_shape))[::-1]
            done = False
            for axes in candidates:
                if done:
                    break
                size = psize * dsize if isinstance(axes, tuple) else dsize
                for ax in order:
                    if spec[ax] is None and _divisible(core_shape[ax], size):
                        spec[ax] = axes
                        done = True
                        break
    # rank 0/1: replicated.
    return PSpec(*([None] * n_stack_dims + spec))


def _stack_dims_for(path: str) -> int:
    low = path.lower()
    if low.startswith(("slot", "enc_layers", "dec_layers", "layers")):
        return 1
    return 0


def params_pspec(params: Tree, mesh, *, zero3: bool = False) -> Tree:
    return tree_map(
        lambda pth, v: param_spec(pth, tuple(v.shape), mesh, zero3=zero3,
                                  n_stack_dims=_stack_dims_for(pth)),
        tree_paths(params), params)


def params_sharding(params: Tree, mesh, *, zero3: bool = False) -> Tree:
    """params_pspec as DTensor placements on `mesh` (a DeviceMesh)."""
    return tree_map(lambda s: placements(s, mesh),
                    params_pspec(params, mesh, zero3=zero3))


def _master_pspec(params_spec: Tree, master_like: Tree) -> Tree:
    """Master weights mirror their parameter's spec; the zero-size
    placeholders the mixed-precision wrappers store for fp32-kept leaves
    (LN/bias) replicate."""
    return tree_map(lambda s, m: s if m.numel() else PSpec(), params_spec,
                    master_like)


def _replicated(tree: Tree) -> Tree:
    """PSpec() for every leaf of a state field (a tensor, a NamedTuple of
    them or a dict tree)."""
    if isinstance(tree, dict):
        return tree_map(lambda _: PSpec(), tree)
    if isinstance(tree, tuple):
        return type(tree)(*(_replicated(t) for t in tree)) \
            if hasattr(tree, "_fields") else tuple(_replicated(t)
                                                   for t in tree)
    return PSpec()


def opt_state_pspec(opt_state, params_spec: Tree,
                    moments_spec: Tree = None):
    """Optimizer moments inherit their parameter's spec; counters
    replicate.

    moments_spec overrides the moment sharding: pass a zero3-style spec
    for ZeRO-1 (optimizer-state sharding over "data" while the weights
    stay only model-sharded).

    Covers the chain states (LansState | LambState | AdamWState |
    FusedState | MomentumState, schedule and scale states), FusedState,
    MixedPrecisionState wrapping a chain state and FusedMixedState. fp32
    masters are optimizer state: they follow the (ZeRO-1 aware) moments
    spec, and loss-scale scalars replicate."""
    from repro_torch.precision.fused import FusedMixedState
    from repro_torch.precision.mixed import MixedPrecisionState

    mspec = moments_spec if moments_spec is not None else params_spec
    if isinstance(opt_state, MixedPrecisionState):
        return MixedPrecisionState(
            loss_scale=_replicated(opt_state.loss_scale),
            master=_master_pspec(mspec, opt_state.master),
            inner=opt_state_pspec(opt_state.inner, params_spec,
                                  moments_spec))
    if isinstance(opt_state, FusedMixedState):
        return FusedMixedState(
            loss_scale=_replicated(opt_state.loss_scale), count=PSpec(),
            master=_master_pspec(mspec, opt_state.master), mu=mspec,
            nu=mspec)
    comps = opt_state if type(opt_state) is tuple else (opt_state,)
    out = []
    for comp in comps:
        if hasattr(comp, "_fields") and set(comp._fields) >= {"mu", "nu"}:
            out.append(comp._replace(count=PSpec(), mu=mspec, nu=mspec))
        elif hasattr(comp, "_fields") and "momentum" in comp._fields:
            out.append(comp._replace(momentum=mspec))
        else:
            out.append(_replicated(comp))
    return tuple(out) if type(opt_state) is tuple else out[0]


def batch_pspec(batch: Tree, mesh) -> Tree:
    """Shard the leading (batch) dim of every input over (pod, data)."""
    baxes = batch_axes(mesh)
    bsize = int(np.prod([_axis_size(mesh, a) for a in baxes]))

    def spec(v):
        if v.ndim == 0:
            return PSpec()
        if v.shape[0] % bsize == 0:
            return PSpec(baxes, *([None] * (v.ndim - 1)))
        return PSpec(*([None] * v.ndim))

    return tree_map(spec, batch)


def _is_integer(dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex
                or dtype == torch.bool)


def _map_cache(fn, cache):
    """fn over the leaves of a tree of dicts and tuples (a PSpec and None
    are leaves; None stays None, as JAX's tree map skips it)."""
    if cache is None:
        return None
    if isinstance(cache, dict):
        return {k: _map_cache(fn, v) for k, v in cache.items()}
    if isinstance(cache, (tuple, list)) and not isinstance(cache, PSpec):
        return type(cache)([_map_cache(fn, v) for v in cache])
    return fn(cache)


def cache_pspec(cache: Tree, mesh) -> Tree:
    """KV / SSM cache sharding for serving, dense and paged layouts.

    kv caches (layers, B, L, kv, hd): B over data (if divisible), hd over
    model. ssm states (layers, B, H, N, P): B over data, N over model.
    conv states (layers, B, W-1, C): B over data, C over model. paged
    arenas (layers, n_blocks, bsz, kv, hd): blocks over data, hd over
    model; encdec cross arenas (layers, n_blocks+1, bsz, H, hd) the same.
    Integer bookkeeping (positions, block tables, cursors) never shards
    over model: only its leading batch/blocks dim goes over data. The
    cache is a tree of dicts and tuples (a decoder's "slots") of
    tensors, or of anything with `ndim`, `shape` and `dtype`."""
    dsize = _axis_size(mesh, "data")
    msize = _axis_size(mesh, "model")

    def spec(v):
        if v.ndim <= 1:
            return PSpec(*([None] * v.ndim))
        s = [None] * v.ndim
        # batch/blocks dim is axis 1 for stacked caches (axis 0 = layers)
        b_ax = 1 if v.ndim >= 3 else 0
        if _divisible(v.shape[b_ax], dsize):
            s[b_ax] = "data"
        if not _is_integer(v.dtype) and _divisible(v.shape[-1], msize):
            s[-1] = "model"
        return PSpec(*s)

    return _map_cache(spec, cache)


def cache_shardings(cache: Tree, mesh) -> Tree:
    """cache_pspec as DTensor placements on `mesh` (JAX's rule; the
    port's pools are placed by ServeLayout)."""
    return _map_cache(lambda s: placements(s, mesh), cache_pspec(cache, mesh))


# --------------------------------------------------------------------------
# serving on a mesh
# --------------------------------------------------------------------------

def head_groups(heads, msize: int) -> int:
    """The number d of head groups a model axis of `msize` ranks cuts
    the attention of `heads` (n_heads, n_kv, head_dim; Arch.heads)
    into: gcd(msize, n_heads, n_kv) where the rules cut all four of wq,
    wk, wv (columns) and wo (rows) over "model" (two or more ranks
    dividing n_heads * head_dim and n_kv * head_dim), else 0 (attention
    gathered in training, whole on every model rank in serving). d ==
    msize is the whole-head split (each rank its own heads); below it,
    the ranks [g msize / d, (g + 1) msize / d) hold the heads of group g
    (use_plan's "heads")."""
    if heads is None or msize < 2:
        return 0
    h, kv, hd = heads
    if (h * hd) % msize or (kv * hd) % msize:
        return 0
    return math.gcd(msize, h, kv)


def head_group(mesh, d: int):
    """This rank's process group of its head group (head_groups: d
    groups of model size / d consecutive ranks of one "model" row of
    `mesh`): the model axis's own group where d is 1. The groups of
    every row are created at the first call for a d, by every rank in
    the same order (a collective over the world group), and kept on the
    mesh: a train step on a mesh creates them when it is built."""
    if d == 1:
        return mesh.get_group("model")
    made = mesh.__dict__.setdefault("_head_groups", {})
    if d not in made:
        import torch.distributed as dist
        msize = _axis_size(mesh, "model")
        rows = mesh.mesh.reshape(-1, msize).tolist()
        r = msize // d
        ranks = [row[g * r:(g + 1) * r] for row in rows for g in range(d)]
        made[d], _ = dist.new_subgroups_by_enumeration(ranks)
    return made[d]


@dataclasses.dataclass(frozen=True)
class Groups:
    """A spec entry of serve_pspec: the dim cut into `n` contiguous
    parts over `axis`, part g whole on each of the axis's ranks [g size
    / n, (g + 1) size / n) (the KV heads of head_groups' groups)."""
    axis: str
    n: int


def serve_pspec(cache: Tree, mesh, heads, mamba=None,
                slots: Optional[int] = None) -> Tree:
    """The serving placement of a (global) pool cache as PSpecs: the
    placement that ServeLayout computes and the pools allocate by
    (serving/cache_pool.py; the tests hold the two equal). cache_pspec
    on the data axis (slots, or arena blocks, over "data" where the size
    divides; nothing over "data" where the pool's `slots` do not divide
    over it: every data rank then holds every slot), and over "model":
    - the KV-head dim of the K/V leaves (those named "k" and "v": (...,
      rows, n_kv, hd)) where the model axis cuts attention
      (head_groups): "model" on whole heads, Groups("model", d) in d
      head groups, never head_dim: the paged kernel takes its softmax
      inside the launch, so a rank must hold every element of its heads'
      q.k;
    - where it cuts the Mamba-2 mixer of config `mamba` on whole heads
      (mamba_split), the SSM state "ssm" (..., B, H, N, P) on its heads
      dim, and the conv tail "conv" (..., B, W - 1, C) on its channels:
      a rank holds the channels its conv_w columns feed (segment_columns
      of conv_w's segments: its heads' x, and B and C whole where the
      groups do not divide), so that entry names the rank's channel set,
      C / m channels only where the groups divide too.
    Nothing else is cut over "model": integer bookkeeping, and the K/V
    or Mamba state of an attention or mixer the model axis does not cut,
    which every model rank then holds whole."""
    msize = _axis_size(mesh, "model")
    d = head_groups(heads, msize)
    kv_entry = ("model" if d == msize else Groups("model", d) if d > 1
                else None)
    msplit = mamba_split(mamba, msize)
    whole_slots = slots is not None and slots % _axis_size(mesh, "data")

    def walk(v, s, name=None):
        if v is None:
            return None
        if isinstance(s, PSpec):
            s = list(s)
            if s and s[-1] == "model":
                s[-1] = None             # head_dim stays whole
            if whole_slots:
                s = [None if e == "data" else e for e in s]
            if kv_entry is not None and name in ("k", "v"):
                s[-2] = kv_entry
            if msplit and name == "ssm":
                s[-3] = "model"
            if msplit and name == "conv":
                s[-1] = "model"
            return PSpec(*s)
        if isinstance(v, dict):
            return {k: walk(v[k], s[k], k) for k in v}
        return type(v)(walk(a, b) for a, b in zip(v, s))

    return walk(cache, cache_pspec(cache, mesh))


def serve_params(params: Tree, mesh, heads, mamba=None) -> Tree:
    """A rank's copy of `params` (whole, the same on every rank) for
    serving on `mesh`: each leaf whose use plan (use_plan, with the
    model's attention `heads` and Mamba-2 config `mamba`) has the model
    axis compute on it becomes the rank's part, placed once here and
    marked with its plan for the models' fetch (models/common.py):
    - "col" / "row": attention wq / wk / wv / wo on whole heads, the
      MLP's up / gate / down, an MoE expert stack cut on its ff dim (E
      does not divide: grok's 8 experts on 16 ranks), a Mamba-2
      out_proj and the wo of attention cut in head groups: the rank's
      columns or rows, the row-parallel products summed over "model"
      in rank order (distributed/partial.py: _sum32);
    - "heads": attention wq / wk / wv cut in d head groups
      (head_groups): the columns of the rank's group, placed here with
      no exchange (every rank holds the whole leaf); the mark carries
      no `groups`, so fetch gathers nothing;
    - "expert": an MoE expert stack cut on E: the rank's E / m experts
      (models/moe.py: _split_experts);
    - "vocab": the token embedding (a decoder's `embed`, whisper's
      `dec_embed`, BERT's `tok_embed`, whose MLM bias the readout slices:
      model_slice) or an untied lm_head: the rank's vocab rows, for the
      vocab-parallel lookup and readout and the picks over the rank's
      logit columns (serving/sampler.py);
    - "mamba": a Mamba-2 in_proj kernel or conv_w, placed at once in the
      columns the rank uses (segment_columns: its heads' z, x and dt,
      and B and C whole where the groups do not divide), where training
      keeps the rule's contiguous columns and exchanges them at every
      use. The mark carries no segments, so fetch does not exchange
      them: serving has no gradient to send back. dt_bias, A_log, D and
      the norm scale stay whole and are sliced at use (models/mamba2.py:
      _mamba_split).
    Every other leaf stays whole and unmarked, as in training's gathered
    ones: norms, biases, position tables, the router kernel (every rank
    needs all E logits), a vocab that does not divide (granite's 49155)
    and attention whose four kernels the rule does not all cut. Nothing
    is cut over "data".
    A part is a copy, never a view of the whole leaf, so that the whole
    tree can be freed once the engine holds its parts."""
    from repro_torch.core.optim.base import tree_map, tree_paths
    pspec = params_pspec(params, mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    msize = _axis_size(mesh, "model")

    def place(path, t, spec):
        use = use_plan(path, spec, mesh, heads, mamba)
        if use is None or use.kind == "gather":
            return t
        dim = dict(use.cuts)["model"]
        rank = coord["model"]
        if use.kind == "mamba":
            cols = torch.as_tensor(segment_columns(use.segments, msize, rank),
                                   dtype=torch.long, device=t.device)
            out = t.index_select(dim, cols)
        elif use.kind == "heads":
            out = t.chunk(use.groups, dim=dim)[rank * use.groups // msize] \
                .clone(memory_format=torch.contiguous_format)
        else:
            out = t.chunk(msize, dim=dim)[rank].clone(
                memory_format=torch.contiguous_format)
        out._use = Use(use.kind, (("model", dim),))
        return out

    return tree_map(place, tree_paths(params), params, pspec)


@dataclasses.dataclass(frozen=True)
class ServeLayout:
    """Where a serving engine's per-slot state lives on a mesh (one
    device: data = model = 1, every slot local).

    `max_batch` slots are cut over the `data` ranks in blocks of
    `block` consecutive slots: data rank d decodes slots [d * block,
    (d + 1) * block) and holds their cache rows, block-table rows and
    its own share of every arena (serving/cache_pool.py). `data` is the
    mesh's data size where the slots divide over it, else 1: every data
    rank then holds and decodes all the slots, as one device does (JAX's
    cache rule keeps such a cache whole on the data axis), and its sums
    over the data ranks count each slot once. Its device structures
    have `rows` rows: the block, or two where the block is one slot, the
    second a dead row (position -1, null table, never admitted), because
    BLAS takes a one-row product down a matrix-vector path whose sums
    run in another order than the many-row product one device runs, so
    a one-slot block would part from one device in its last bits.
    `groups` is the number of head groups the `model` axis cuts
    attention into (head_groups; 1 where it does not cut it): a rank
    then holds n_kv / groups KV heads of every cache and arena
    (local_heads), the same heads as every rank of its group. `mamba`
    is the number of ranks a Mamba-2 mixer's heads are cut over: the
    model size where it cuts the mixer on whole heads (mamba_split),
    else 1; a rank's SSM state and conv tail are then its heads' and
    channels' (local_mamba, models/mamba2.py: local_cfg)."""
    max_batch: int
    data: int = 1
    model: int = 1
    data_rank: int = 0
    groups: int = 1
    mamba: int = 1

    @property
    def block(self) -> int:
        return self.max_batch // self.data

    @property
    def rows(self) -> int:
        return max(self.block, 2) if self.data > 1 else self.max_batch

    @property
    def lo(self) -> int:
        return self.data_rank * self.block

    def shard(self, slot: int) -> int:
        """The data rank that holds `slot`."""
        return slot // self.block

    def owns(self, slot: int) -> bool:
        return self.shard(slot) == self.data_rank

    def local(self, slot: int) -> int:
        """`slot`'s row within its data rank's block."""
        return slot % self.block

    def at(self, slot: int):
        """(the data rank that holds `slot`, its row there); IndexError
        outside [0, max_batch)."""
        if not (0 <= slot < self.max_batch):
            raise IndexError(f"slot {slot} out of range [0, "
                             f"{self.max_batch})")
        return self.shard(slot), self.local(slot)

    def plan_key(self, shard: int, key):
        """A pool's admission-plan key: `key` (a slot-type), paired with
        the data rank's share on a data mesh."""
        return key if self.data == 1 else (shard, key)

    def local_heads(self, n: int) -> int:
        """A model rank's share of `n` attention (or KV) heads: its head
        group's."""
        return n // self.groups

    def cache_kw(self, n_kv: int) -> dict:
        """The keyword arguments of a rank's cache of a model with `n_kv`
        KV heads (configs/base.py: Arch.init_cache, init_paged_cache,
        prefill): its KV heads and the ranks its Mamba heads are cut
        over."""
        return dict(kv_heads=self.local_heads(n_kv), mamba_ranks=self.mamba)

    def pad_rows(self, x, fill=0):
        """A (block, ...) array or tensor padded with `fill` to `rows`
        rows."""
        pad = self.rows - x.shape[0]
        if pad == 0:
            return x
        if torch.is_tensor(x):
            return torch.cat([x, torch.full((pad, *x.shape[1:]), fill,
                                            dtype=x.dtype, device=x.device)])
        return np.concatenate([x, np.full((pad, *x.shape[1:]), fill,
                                          dtype=x.dtype)])

    def local_rows(self, x, fill=0):
        """This rank's rows of a (max_batch, ...) array or tensor, padded
        with `fill` to `rows` rows."""
        return self.pad_rows(x[self.lo:self.lo + self.block], fill)


def serve_layout(heads, max_batch: int, mesh=None,
                 mamba=None) -> ServeLayout:
    """The ServeLayout of `max_batch` slots on `mesh` (None: one
    device), for a model of attention `heads` (Arch.heads) and Mamba-2
    config `mamba` (None: no Mamba mixer). Slots that do not divide over
    "data" are whole on every data rank; a mesh never falls back to one
    device."""
    if mesh is None:
        return ServeLayout(max_batch)
    shape = mesh_shape(mesh)
    if "pod" in shape:
        raise ValueError("serving takes a (data, model) mesh")
    data, model = shape.get("data", 1), shape.get("model", 1)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    if max_batch % data:
        data, coord["data"] = 1, 0
    return ServeLayout(max_batch, data, model, coord.get("data", 0),
                       max(head_groups(heads, model), 1),
                       model if mamba_split(mamba, model) else 1)


# --------------------------------------------------------------------------
# use plans
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Use:
    """How the models use one cut leaf in a step on a mesh: `kind`
    "col", "row", "expert", "vocab", "mamba" or "heads" (the model shard
    is used as it is, a "mamba" one after its exchange, a "heads" one
    gathered over its head group) or "gather" (gathered whole at its
    use); `cuts` the (axis name, tensor dim) pairs the leaf is cut on,
    in the mesh's dim order; `segments` a "mamba" leaf's parts of its
    model-cut dim, (size, split) each (mamba_segments), which fetch
    exchanges it into; `groups` a "heads" leaf's head groups
    (head_groups), over whose ranks fetch gathers it. A leaf already
    placed in the rank's columns (serve_params) has neither."""
    kind: str
    cuts: tuple
    segments: tuple = ()
    groups: int = 0

    @property
    def gathered(self) -> tuple:
        """The cuts the fetch all-gathers: all of them, or all but the
        model cut of a leaf used as its model shard."""
        return tuple(c for c in self.cuts
                     if self.kind == "gather" or c[0] != "model")

    def unstacked(self) -> "Use":
        """The plan of one layer's slice of a stacked leaf."""
        return Use(self.kind, tuple((a, d - 1) for a, d in self.cuts),
                   self.segments, self.groups)


_COLUMN = ("wq", "wk", "wv", "up", "gate")
_ROW = ("wo", "down")


def mamba_split(mamba, msize: int) -> bool:
    """Does a model axis of `msize` ranks cut a Mamba-2 mixer of config
    `mamba` (models/mamba2.py: MambaConfig) on whole heads: two or more
    ranks, dividing its heads, its groups or there being one group
    (then B and C stay whole on every rank), and its in_proj and conv_w
    columns (the rule cuts them only then)?"""
    if mamba is None or msize < 2:
        return False
    h, g, gn = mamba.nheads, mamba.ngroups, mamba.ngroups * mamba.dstate
    return (h % msize == 0 and (g % msize == 0 or g == 1)
            and (2 * mamba.d_inner + 2 * gn + h) % msize == 0
            and (mamba.d_inner + 2 * gn) % msize == 0)


def mamba_segments(leaf: str, mamba, msize: int) -> tuple:
    """The parts of a Mamba-2 leaf's cut dim, (size, split) each: split
    parts are cut over the ranks by heads (or groups), the others whole
    on every rank. in_proj's columns are [z, x, B, C, dt], conv_w's [x,
    B, C] (models/mamba2.py)."""
    head = mamba.nheads * mamba.headdim
    gn = mamba.ngroups * mamba.dstate
    groups = mamba.ngroups % msize == 0
    if leaf == "in_proj":
        return ((head, True), (head, True), (gn, groups), (gn, groups),
                (mamba.nheads, True))
    return ((head, True), (gn, groups), (gn, groups))


@functools.lru_cache(maxsize=None)
def segment_columns(segments: tuple, msize: int, rank: int) -> tuple:
    """The indices along the cut dim that `rank` of `msize` uses: its
    chunk of each split part and all of each whole one, in order."""
    out, start = [], 0
    for size, split in segments:
        lo, n = ((rank * size // msize, size // msize) if split
                 else (0, size))
        out.extend(range(start + lo, start + lo + n))
        start += size
    return tuple(out)


def use_plan(path: str, spec: PSpec, mesh, heads=None,
             mamba=None) -> Optional[Use]:
    """The use plan of the leaf at `path` placed by `spec` on `mesh`
    (None: not cut, used as it is). heads: (n_heads, n_kv, head_dim) of
    the model's attention (Arch.heads), without which attention is never
    split; mamba: its Mamba-2 mixer's config, without which Mamba is
    never split."""
    order = list(mesh_shape(mesh))
    cuts = sorted(((name, d) for d, entry in enumerate(spec)
                   for name in (entry if isinstance(entry, tuple) else
                                () if entry is None else (entry,))),
                  key=lambda c: order.index(c[0]))
    if not cuts:
        return None
    model = dict(cuts).get("model")
    kind, segments, groups = "gather", (), 0
    if model is None:
        return Use(kind, tuple(cuts))
    parts = path.lower().split("/")
    name = parts[-1]
    owner = parts[-2] if len(parts) >= 2 and name == "kernel" else None
    msize = _axis_size(mesh, "model")
    d = head_groups(heads, msize)
    last, rows = len(spec) - 1, len(spec) - 2
    if owner in ("up", "gate", "down") or (
            owner in ("wq", "wk", "wv", "wo") and d == msize):
        if owner in _COLUMN and model == last:
            kind = "col"
        elif owner in _ROW and model == rows:
            kind = "row"
    elif owner in ("wq", "wk", "wv", "wo") and d:
        if owner != "wo" and model == last:
            kind, groups = "heads", d
        elif owner == "wo" and model == rows:
            kind = "row"
    elif owner is None and name in ("up", "gate", "down") and len(spec) >= 3:
        # an MoE expert stack (..., E, din, dout)
        if model == len(spec) - 3:
            kind = "expert"
        elif name in _COLUMN and model == last:
            kind = "col"
        elif name in _ROW and model == rows:
            kind = "row"
    elif (name == "embedding" and model == 0) or (owner == "lm_head"
                                                  and model == last):
        kind = "vocab"
    elif mamba_split(mamba, msize):
        if (owner == "in_proj" or name == "conv_w") and model == last:
            kind = "mamba"
            segments = mamba_segments(owner or name, mamba, msize)
        elif owner == "out_proj" and model == rows:
            kind = "row"
    return Use(kind, tuple(cuts), segments, groups)


def spec_of(t, mesh) -> PSpec:
    """The PSpec a DTensor is placed by (the inverse of `placements`);
    PSpec() for a plain tensor."""
    places = getattr(t, "placements", None)
    if places is None:
        return PSpec()
    entries = [[] for _ in range(t.ndim)]
    for name, p in zip(mesh.mesh_dim_names, places):
        if p.is_shard():
            entries[p.dim].append(name)
    return PSpec(*(tuple(e) if e else None for e in entries))


def params_uses(params: Tree, mesh, heads=None, mamba=None) -> Tree:
    """use_plan of every leaf of `params` (placed on `mesh`), by its
    placements."""
    return tree_map(lambda pth, v: use_plan(pth, spec_of(v, mesh), mesh,
                                            heads, mamba),
                    tree_paths(params), params)


# --------------------------------------------------------------------------
# DTensor placements
# --------------------------------------------------------------------------

def placements(spec: PSpec, mesh) -> tuple:
    """DTensor placements of `spec` on `mesh` (a DeviceMesh with
    mesh_dim_names): Shard(d) on each mesh dim that names tensor dim d (a
    tuple such as ("pod", "data") on one dim gives Shard(d) on both mesh
    dims, the first named the outer split, as in JAX), Replicate() on
    every other mesh dim."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for name in (entry if isinstance(entry, tuple)
                     else () if entry is None else (entry,)):
            if name not in names:
                raise ValueError(f"spec {spec} names axis {name!r}, not on "
                                 f"the mesh {names}")
            out[names.index(name)] = Shard(d)
    return tuple(out)


def local_shard(t: torch.Tensor, mesh, places) -> torch.Tensor:
    """This rank's block of the whole tensor `t` under `places`: for each
    mesh dim in order, the coordinate's chunk along its Shard dim (even
    chunks: the rules only shard dims the axis size divides). A block is
    a copy, never a view that would keep the whole tensor's storage
    alive (a chunk of an outer dim is contiguous as it is)."""
    coord = mesh.get_coordinate()
    cut = False
    for md, p in enumerate(places):
        if p.is_shard():
            n = mesh.size(md)
            if t.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(t.shape)} does not "
                                 f"split evenly over {n} ranks")
            t = t.chunk(n, dim=p.dim)[coord[md]]
            cut = True
    return t.clone(memory_format=torch.contiguous_format) if cut else \
        t.contiguous()


def distribute_leaf(t, mesh, spec: PSpec):
    """One tensor placed on `mesh` by `spec`: a DTensor built from this
    rank's block of `t` (every rank holds the whole `t`, as every rank
    builds the same params from one seed, so nothing is sent). 0-d and
    empty tensors (counters, loss-scale scalars, the masters' zero-size
    placeholders) stay plain: every rank computes the same value. A
    DTensor is redistributed to the spec's placements."""
    from torch.distributed.tensor import DTensor
    if t is None:
        return None
    places = placements(spec, mesh)
    if isinstance(t, DTensor):
        return t.redistribute(mesh, places)
    if t.ndim == 0 or t.numel() == 0:
        return t
    return DTensor.from_local(local_shard(t, mesh, places), mesh, places,
                              run_check=False)


def _map_spec(fn, tree, spec):
    """fn(leaf, spec) over a tree of dicts, tuples and NamedTuples whose
    spec tree has the same structure (a PSpec is a leaf of the spec
    tree)."""
    if isinstance(spec, PSpec):
        return fn(tree, spec)
    if isinstance(tree, dict):
        return {k: _map_spec(fn, tree[k], spec[k]) for k in tree}
    if isinstance(tree, tuple):
        vals = [_map_spec(fn, t, s) for t, s in zip(tree, spec)]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    raise TypeError(f"no spec for {type(tree).__name__}")


def distribute(tree: Tree, mesh, spec_tree: Tree) -> Tree:
    """Every leaf of `tree` placed on `mesh` by the matching PSpec of
    `spec_tree` (distribute_leaf): params by params_pspec, an optimizer
    state by opt_state_pspec, a cache by cache_pspec."""
    return _map_spec(lambda t, s: distribute_leaf(t, mesh, s), tree,
                     spec_tree)


def constrain(tree: Tree, mesh, spec_tree: Tree) -> Tree:
    """Each DTensor leaf redistributed to its spec's placements (the
    counterpart of with_sharding_constraint); plain leaves are placed."""
    return distribute(tree, mesh, spec_tree)
