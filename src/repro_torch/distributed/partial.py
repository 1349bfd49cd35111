"""Sums that span ranks: the parts of the global batch's loss and
gradients, and the per-leaf sums of squares of a leaf cut over ranks.

A train step on a mesh (distributed/steps.py) gives every rank its block
of the global batch; the losses take their means over the whole batch
(models/common.py: WHOLE), so that each rank's loss and gradients are
its PARTS of the whole batch's, and `sum_over` adds them up.

The fused optimizers (core/optim/fused.py, precision/fused.py) run their
kernels on each rank's shard of a leaf. K1's sum of squares and K2's /
K5's norms are then partial sums, which `reduce_partials` adds over the
mesh dims the leaf is cut over, one all-reduce of a stacked batch per
group of leaves and mesh dim (counted in `reduce_partials.calls`).

The models' use of a cut leaf inside the step (models/common.py: fetch)
goes through the autograd functions below:

  gather_leaf     all-gather a leaf over the mesh dims it is cut on; the
                  backward pass hands the rank the gradient of its own
                  shard: reduce-scattered over a data dim (zero3: the sum
                  over the data ranks), sliced on a model dim (the model
                  ranks of one data block compute the same gradient);
  copy_to_model   Megatron's f, at a column-parallel input: identity
                  forward, a sum over "model" backward (each model rank
                  holds a part of the input's gradient);
  reduce_from_model  Megatron's g, at a row-parallel output: a sum over
                  "model" forward, identity backward (both sum in fp32
                  at least, whatever the compute dtype, and in rank
                  order: _sum32);
  model_slice     the rank's slice of a replicated leaf used with
                  column-parallel outputs (a bias), its gradient
                  all-gathered back over "model" to the whole leaf's;
  model_take      the same for any index set of the rank's (a Mamba
                  conv bias: its heads' channels and B / C whole), the
                  ranks' gradients summed in rank order;
  all_sum         a sum over "model" whose every rank uses the total on
                  its own part (a norm's sum of squares over a cut dim):
                  summed in rank order forward and backward;
  exchange        a leaf cut on contiguous columns at rest turned into
                  the columns the rank uses (a Mamba in_proj / conv_w:
                  its heads', and B / C whole), one all-to-all of the
                  layer's shards; the backward pass sends each gradient
                  back to the rank that holds its column and sums the
                  ranks' parts of a column they all used in rank order.
"""
from __future__ import annotations

import functools

import torch
import torch.distributed as dist


def sum_over(t, groups):
    """A detached copy of `t` summed over the ranks of each process group
    in `groups`."""
    total = torch.as_tensor(t).detach().clone()
    for g in groups:
        dist.all_reduce(total, group=g)
    return total


def whole(t):
    """A DTensor's whole value as a plain tensor on every rank
    (full_tensor); any other tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def reduce_partials(t: torch.Tensor, groups) -> torch.Tensor:
    """Sum `t` (a stacked batch of partial sums) in place over each process
    group in `groups`; returns it."""
    for g in groups:
        dist.all_reduce(t, group=g)
        reduce_partials.calls += 1
    return t


reduce_partials.calls = 0


def all_gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' `t` (equal shapes) concatenated on `dim`, in rank order
    of `group`."""
    n = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0], *src.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.all_gather_into_tensor(out, src, group=group)
    # contiguous, as the leaf it rebuilds: a matmul's sums then run in
    # the same order as on the whole leaf
    return out.movedim(0, dim).contiguous()


def reduce_scatter_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of the ranks' `t` over `group`, cut into equal chunks on
    `dim`: this rank's chunk."""
    n = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n, *src.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def max_over(t, group):
    """A detached copy of `t`, its elementwise maximum over `group`."""
    top = t.detach().clone()
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
    return top


def _chunk(t, dim, group):
    """This rank's chunk of `t` on `dim`, cut evenly over `group`."""
    return t.chunk(dist.get_world_size(group), dim=dim)[
        dist.get_rank(group)].contiguous()


class _Gather(torch.autograd.Function):
    """cuts: ((group, dim, summed), ...) in the mesh's dim order, the
    order a shard is cut in (sharding.local_shard); `summed`: the
    backward pass sums that dim's ranks (a data dim) rather than slicing
    (the model dim)."""

    @staticmethod
    def forward(ctx, t, cuts):
        ctx.cuts = cuts
        for group, dim, _ in reversed(cuts):
            t = all_gather_dim(t, dim, group)
        return t

    @staticmethod
    def backward(ctx, g):
        for group, dim, summed in ctx.cuts:
            g = (reduce_scatter_dim(g, dim, group) if summed
                 else _chunk(g, dim, group))
        return g, None


def gather_leaf(t, cuts):
    """A leaf's shard gathered over `cuts` (see _Gather)."""
    if not cuts:
        return t
    return _Gather.apply(t, tuple(cuts))


def _sum32(t, group):
    """t summed over `group` in fp32 at least (a bf16 / fp16 part is
    added in fp32 and rounded once, after the sum; fp32 and float64 stay
    as they are), returned in t's dtype. The ranks' parts are gathered
    and added in rank order, so that every rank gets the same bits
    whatever order the backend's all-reduce would take (for two ranks
    the two are the same; for more it moves (n - 1) parts per rank, not
    2 (n - 1) / n)."""
    acc = torch.promote_types(t.dtype, torch.float32)
    parts = all_gather_dim(t.to(acc).unsqueeze(0), 0, group)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total.to(t.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum32(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group):
        return _sum32(y, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ModelSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return _chunk(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.dim, ctx.group).contiguous(), None, None


def copy_to_model(x, group):
    """Megatron's f: x as it is, its gradient summed over `group`."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(y, group):
    """Megatron's g: y summed over `group`, its gradient as it is."""
    return _ReduceFromModel.apply(y, group)


def model_slice(t, dim, group):
    """This rank's chunk of `t` on `dim` over `group`, its gradient
    assembled over `group` into the whole tensor's."""
    return _ModelSlice.apply(t, dim, group)


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _sum32(t, group)

    @staticmethod
    def backward(ctx, g):
        return _sum32(g, ctx.group), None


def all_sum(t, group):
    """t summed over `group` in rank order, for every rank to use on its
    own part: its gradient is summed over `group` the same way."""
    return _AllSum.apply(t, group)


class _ModelTake(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, idx, group):
        ctx.shape, ctx.idx, ctx.group = t.shape, idx, group
        return t.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        acc = torch.promote_types(g.dtype, torch.float32)
        full = torch.zeros(ctx.shape, dtype=acc, device=g.device)
        full.index_copy_(0, ctx.idx, g.to(acc))
        return _sum32(full, ctx.group).to(g.dtype), None, None


def model_take(t, idx, group):
    """Rows `idx` (a list, this rank's) of the replicated `t`, its
    gradient assembled over `group` into the whole tensor's: the ranks'
    parts added in rank order (a row several ranks take gets their sum)."""
    return _ModelTake.apply(t, torch.as_tensor(idx, device=t.device), group)


@functools.lru_cache(maxsize=None)
def exchange_plan(size: int, segments: tuple, n: int, rank: int):
    """(sent, received) of `rank` among `n` ranks that hold contiguous
    chunks of a dim of `size` and use the indices segment_columns gives
    each (distributed/sharding.py): sent[t] the indices of this rank's
    chunk that rank t uses, in order; received[s] the count of its own
    indices rank s holds. Rank t's indices ascend, and so do the chunks,
    so what it receives from the ranks in order is its indices in
    order."""
    from repro_torch.distributed.sharding import segment_columns
    chunk = size // n
    sent = tuple(tuple(c - rank * chunk for c in segment_columns(
        segments, n, t) if rank * chunk <= c < (rank + 1) * chunk)
        for t in range(n))
    mine = segment_columns(segments, n, rank)
    received = tuple(sum(1 for c in mine if s * chunk <= c < (s + 1) * chunk)
                     for s in range(n))
    return sent, received


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, segments, group):
        n, rank = dist.get_world_size(group), dist.get_rank(group)
        sent, received = exchange_plan(t.shape[dim] * n, segments, n, rank)
        idx = torch.as_tensor([i for s in sent for i in s], dtype=torch.long,
                              device=t.device)
        ctx.dim, ctx.group, ctx.shape = dim, group, t.shape
        ctx.sent, ctx.received, ctx.idx = sent, received, idx
        src = t.movedim(dim, 0).index_select(0, idx).contiguous()
        out = torch.empty((sum(received), *src.shape[1:]), dtype=t.dtype,
                          device=t.device)
        dist.all_to_all_single(out, src, list(received),
                               [len(s) for s in sent], group=group)
        return out.movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        src = g.movedim(ctx.dim, 0).contiguous()
        back = torch.empty((ctx.idx.numel(), *src.shape[1:]), dtype=g.dtype,
                           device=g.device)
        dist.all_to_all_single(back, src, [len(s) for s in ctx.sent],
                               list(ctx.received), group=ctx.group)
        acc = torch.promote_types(g.dtype, torch.float32)
        shape = list(ctx.shape)
        shape.insert(0, shape.pop(ctx.dim))
        grad = torch.zeros(shape, dtype=acc, device=g.device)
        start = 0
        for sent in ctx.sent:          # rank order: a shared column's sum
            n = len(sent)
            grad.index_add_(0, ctx.idx[start:start + n],
                            back[start:start + n].to(acc))
            start += n
        return grad.to(g.dtype).movedim(0, ctx.dim).contiguous(), None, \
            None, None


def exchange(t, dim, segments, group):
    """A rank's contiguous chunk `t` of a leaf cut on `dim` over `group`
    turned into the indices of that dim the rank uses (segment_columns
    of `segments`), in order: one all-to-all moves to each rank what it
    uses of the others' chunks (see _Exchange for the backward pass)."""
    return _Exchange.apply(t, dim, segments, group)
