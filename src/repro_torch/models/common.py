"""Functional building blocks over dicts of tensors (port of
repro/models/common.py).

Params are nested dicts of tensors with the JAX package's keys and
layouts: dense kernels are stored (in, out), embeddings (vocab, dim),
RMSNorm scales in the gemma (1 + scale) form, LayerNorm as scale and
bias. Models keep params in
`param_dtype` and cast to `compute_dtype` at use.

On a mesh (a train step of distributed/steps.py) the models run on each
rank's shards. The step sets the ambient mesh (`ambient_mesh`, the JAX
package's ambient_axis_size reads it) and marks every cut leaf with its
use plan (distributed/sharding.py: use_plan). Each leaf goes through
`fetch` at its use: `layer_params` fetches one layer's leaves, which the
models call inside the layer's recomputed region, so that only the
shards are kept for the backward pass; the other leaves are fetched
where they are used. Off a mesh `fetch` is the identity. A leaf the
model axis computes on comes back as its model shard (a Mamba
projection's after its exchange), marked with its kind, and the
functions that use it do the rank's part:
- `dense_apply`: a column-parallel kernel's bias is taken as the
  rank's slice (a "heads" kernel's, its head group's) and its input's
  gradient is summed over "model", a row-parallel product is summed
  over "model" before its bias is added;
  `tp_enter` marks a replicated leaf used on a column-parallel block's
  local heads (a QK-norm scale), whose gradient the model ranks sum;
- a vocab-cut table or lm_head: `embed_apply` looks up the rank's rows
  (zero for ids outside them) and sums the ranks' parts over "model";
  `embed_attend` and `dense_apply` give the rank's (..., V / m) logits,
  marked vocab-parallel (`is_vocab`), on which `log_likelihood` takes
  the log-softmax with its max and its sum of exponentials over
  "model" (in rank order) and the label's logit from the rank that
  owns it;
- MoE expert stacks and Mamba-2 mixers: models/moe.py, models/mamba2.py.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

# The batch key under which a block of a larger batch (one rank's, in a
# train step on a mesh: distributed/steps.py) carries that whole batch.
# A loss that is a mean takes it over the whole batch's count, so that
# the blocks' losses, and their gradients, add up to the whole batch's.
WHOLE = "whole"


@dataclasses.dataclass
class Ambient:
    """What the models read of the mesh a step runs on: the mesh (a
    DeviceMesh, whose groups the fetch and the tensor-parallel ops use,
    or a stand-in with a `shape` dict) and the axes this call's batch is
    cut over (`cut`; empty when the call holds the whole batch)."""
    mesh: Any
    cut: tuple = ()

    @property
    def sizes(self) -> dict:
        from repro_torch.distributed.sharding import mesh_shape
        return mesh_shape(self.mesh)

    @property
    def blocks(self) -> int:
        """The number of blocks the batch is cut into."""
        return math.prod(self.sizes[a] for a in self.cut)

    def group(self, name):
        return self.mesh.get_group(name)

    def data_sum(self, t):
        """t (no gradient) summed over the ranks of the axes the batch is
        cut over."""
        from repro_torch.distributed.partial import sum_over
        return sum_over(t, [self.group(a) for a in self.cut])


# a stack, not thread-local: the backward pass (and the recompute of a
# checkpointed layer in it) runs on the autograd engine's device thread
_AMBIENT: list = []


@contextlib.contextmanager
def ambient_mesh(ctx: Ambient):
    """Make `ctx` the ambient mesh while the block runs (the forward and
    the backward pass of a step on a mesh)."""
    _AMBIENT.append(ctx)
    try:
        yield ctx
    finally:
        _AMBIENT.pop()


def ambient() -> Optional[Ambient]:
    return _AMBIENT[-1] if _AMBIENT else None


def ambient_axis_size(name: str) -> int:
    """Size of a named axis of the ambient mesh (1 if absent or
    unmeshed)."""
    amb = ambient()
    return 1 if amb is None else amb.sizes.get(name, 1)


def fetch(t):
    """A leaf ready for its use: off a mesh, or not cut, `t` itself; a
    tensor-parallel leaf its model shard (gathered over a data axis it is
    also cut on; a "heads" leaf over its head group too, its gradient
    reduce-scattered there), marked with its kind (`tp_kind`); any other
    cut leaf gathered whole (distributed/partial.py: gather_leaf), its
    gradient the rank's shard's."""
    use = getattr(t, "_use", None)
    if use is None:
        return t
    from repro_torch.distributed.partial import exchange, gather_leaf
    from repro_torch.distributed.sharding import head_group
    amb = ambient()
    cuts = [(amb.group(a), d, a in amb.cut) for a, d in use.gathered]
    if use.groups:             # the model axis is last in the mesh's order
        cuts.append((head_group(amb.mesh, use.groups),
                     dict(use.cuts)["model"], True))
    out = gather_leaf(t, cuts)
    if use.segments:           # used as the columns of its ranks' heads
        out = exchange(out, dict(use.cuts)["model"], use.segments,
                       amb.group("model"))
    if use.kind != "gather":
        out._tp = use.kind
    return out


def fetch_tree(tree):
    """fetch over the leaves of a dict tree."""
    return {k: fetch_tree(v) if isinstance(v, dict) else fetch(v)
            for k, v in tree.items()}


def tp_kind(w) -> Optional[str]:
    """The use plan's kind of a fetched leaf that the model axis computes
    on ("col", "row", "expert", "vocab", "mamba"), else None."""
    return getattr(w, "_tp", None)


# kinds whose output is the rank's columns, its input's gradient summed
# over "model" (Megatron's f): an in_proj's columns are its heads', a
# "heads" kernel's its head group's
_COL_KINDS = ("col", "vocab", "mamba", "heads")


def is_vocab(logits) -> bool:
    """Are `logits` a rank's vocab-parallel (..., V / m) columns?"""
    return getattr(logits, "_vocab", False)


def keep_vocab(out, logits):
    """`out`, computed elementwise from `logits`, marked vocab-parallel
    where they are."""
    if is_vocab(logits):
        out._vocab = True
    return out


def _model():
    """(the model axis's process group, this rank's index in it)."""
    import torch.distributed as dist
    group = ambient().group("model")
    return group, dist.get_rank(group)


def tp_enter(t, w):
    """t used on the local heads or columns of a block whose kernel `w` is
    column parallel, on whole heads or in head groups (a QK-norm scale):
    the same t, its gradient summed over "model" in the backward pass
    (each rank's part comes from its own heads, or its own rows of wo);
    t itself otherwise."""
    if tp_kind(w) not in ("col", "heads"):
        return t
    from repro_torch.distributed.partial import copy_to_model
    return copy_to_model(t, ambient().group("model"))


def _randn(gen: Optional[torch.Generator], shape):
    """Standard normal draw from `gen` on its device; gen=None draws on
    the ambient default device (e.g. under `torch.device("meta")`, which
    gives the shapes of an init without its memory)."""
    return torch.randn(shape, generator=gen,
                       device=None if gen is None else gen.device)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, *,
               use_bias: bool = False, dtype=torch.float32,
               scale: Optional[float] = None, lead: tuple = ()):
    """`lead` prepends stacking dims (the decoder stacks each slot's
    params over its periods, as the JAX package's vmapped init does)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = _randn(gen, (*lead, in_dim, out_dim))
    p = {"kernel": (w * scale).to(dtype)}
    if use_bias:
        p["bias"] = torch.zeros((*lead, out_dim), dtype=dtype,
                                device=w.device)
    return p


def dense_apply(p, x, compute_dtype=torch.bfloat16):
    """x @ kernel + bias; with a tensor-parallel kernel (fetch) the rank's
    part: its columns (a "heads" kernel: its head group's) and its slice
    of the bias, x's gradient summed over "model" (Megatron's f), or its
    rows' product summed over "model" and then the bias added once
    (Megatron's g). A row-parallel kernel handed more columns than it
    has rows (a head group's attention output, whose rows the group's
    ranks share) multiplies the rank's own slice of them. A split
    product is taken at fp32 at least, from operands rounded to
    compute_dtype, and so is x's gradient under f: each is rounded to
    compute_dtype once, after its sum over "model", as one device's
    matmul rounds its fp32 accumulator once."""
    w = p["kernel"]
    kind = tp_kind(w)
    if kind is None:
        y = torch.matmul(x.to(compute_dtype), w.to(compute_dtype))
    else:
        from repro_torch.distributed import partial
        group = ambient().group("model")
        acc = torch.promote_types(compute_dtype, torch.float32)
        x = x.to(compute_dtype).to(acc)
        if kind in _COL_KINDS:
            x = partial.copy_to_model(x, group)
        elif kind == "row" and x.shape[-1] != w.shape[-2]:
            n = w.shape[-2]
            j = dist.get_rank(group) % (x.shape[-1] // n)
            x = x[..., j * n:(j + 1) * n]
        y = torch.matmul(x, w.to(compute_dtype).to(acc))
        if kind == "row":
            y = partial.reduce_from_model(y, group)
        y = y.to(compute_dtype)
    if "bias" in p:
        b = p["bias"]
        if kind == "col":
            b = partial.model_slice(b, b.ndim - 1, group)
        elif kind == "heads":
            b = _group_part(b, w.shape[-1], group)
        y = y + b.to(compute_dtype)
    if kind == "vocab":
        y._vocab = True
    return y


def _group_part(b, n: int, group):
    """The rank's head group's `n` entries of the last dim of the whole
    (replicated) bias `b` (the group's columns of a "heads" kernel), its
    gradient summed over "model" in rank order into the whole bias's:
    the ranks of a group each hold a part of their columns'."""
    from repro_torch.distributed.partial import model_take
    d = b.shape[-1] // n
    g = dist.get_rank(group) * d // dist.get_world_size(group)
    part = model_take(b.movedim(-1, 0), list(range(g * n, (g + 1) * n)),
                      group)
    return part.movedim(0, -1)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype=torch.float32):
    e = _randn(gen, (vocab, dim))
    return {"embedding": (e * 0.02).to(dtype)}


def embed_apply(p, ids, compute_dtype=torch.bfloat16):
    table = p["embedding"]
    if tp_kind(table) == "vocab":
        return _vocab_lookup(table, ids, compute_dtype)
    return table[ids.long()].to(compute_dtype)


def _vocab_lookup(table, ids, compute_dtype):
    """The rows of `ids` from a rank's rows of a vocab-cut table: its
    own, zero for the others, summed over "model" (one part is not
    zero, so the sum is exact); the gradient reaches its own rows."""
    from repro_torch.distributed.partial import reduce_from_model
    group, rank = _model()
    n = table.shape[0]
    local = ids.long() - rank * n
    mine = (local >= 0) & (local < n)
    rows = table[torch.where(mine, local, 0)] * mine[..., None].to(
        table.dtype)
    return reduce_from_model(rows, group).to(compute_dtype)


def embed_attend(p, x, compute_dtype=torch.bfloat16, bias=None):
    """Tied-readout logits: x @ E^T, plus an fp32 `bias` (V,) when given
    (the logits then fp32); a rank's vocab-parallel columns of them for a
    vocab-cut table."""
    table = p["embedding"]
    if tp_kind(table) == "vocab":
        return _vocab_readout(table, x, compute_dtype, bias)
    y = torch.matmul(x.to(compute_dtype), table.to(compute_dtype).t())
    return y if bias is None else y.float() + bias.float()


def _vocab_readout(table, x, compute_dtype, bias=None):
    """A rank's columns of x @ E^T from its rows of E, as dense_apply's
    column-parallel product (at fp32 at least, x's gradient summed over
    "model"), plus its slice of `bias`; marked vocab-parallel."""
    from repro_torch.distributed import partial
    group, _ = _model()
    acc = torch.promote_types(compute_dtype, torch.float32)
    x = partial.copy_to_model(x.to(compute_dtype).to(acc), group)
    y = torch.matmul(x, table.to(compute_dtype).to(acc).t()).to(
        compute_dtype)
    if bias is not None:
        y = y.float() + partial.model_slice(bias, 0, group).float()
    y._vocab = True
    return y


def log_likelihood(logits, labels):
    """fp32 log p(label) at each position of `logits` (..., V), labels
    (...) ids in [0, V); on vocab-parallel logits (is_vocab) the same,
    from every rank's columns (_vocab_log_likelihood)."""
    if is_vocab(logits):
        return _vocab_log_likelihood(logits, labels)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(logp, -1, labels.long()[..., None])[..., 0]


def _vocab_log_likelihood(logits, labels):
    """log p(label) from a rank's (..., V / m) logits: the label's logit
    (from the rank that holds it, summed over "model") less the
    log-sum-exp, its max taken over "model" and its sum of exponentials
    summed over "model" in rank order. The gradient of a rank's logits is
    its part of softmax - onehot."""
    from repro_torch.distributed import partial
    group, rank = _model()
    z = logits.float()
    n = z.shape[-1]
    top = partial.max_over(z.amax(-1, keepdim=True), group)
    total = partial.reduce_from_model(torch.exp(z - top).sum(-1), group)
    local = labels.long() - rank * n
    mine = (local >= 0) & (local < n)
    picked = torch.gather(z, -1, torch.where(mine, local, 0)[..., None])
    picked = partial.reduce_from_model(picked[..., 0] * mine, group)
    return picked - top[..., 0] - torch.log(total)


def rmsnorm_init(dim: int, dtype=torch.float32, device=None,
                 lead: tuple = ()):
    return {"scale": torch.zeros((*lead, dim), dtype=dtype, device=device)}


def rmsnorm_apply(p, x, eps: float = 1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + p["scale"].float())).to(x.dtype)


def layernorm_init(dim: int, dtype=torch.float32, device=None,
                   lead: tuple = ()):
    return {"scale": torch.ones((*lead, dim), dtype=dtype, device=device),
            "bias": torch.zeros((*lead, dim), dtype=dtype, device=device)}


def layernorm_apply(p, x, eps: float = 1e-6):
    """LayerNorm with fp32 statistics, returned in x's dtype."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    xc = x32 - mu
    var = torch.mean(xc * xc, dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def softcap(x, cap: Optional[float]):
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


def rope_freqs(head_dim: int, theta: float = 10000.0, device="cpu"):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 10000.0):
    """Split-half RoPE. x: (..., seq, heads, head_dim); positions
    broadcastable to (..., seq)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def unbind_layers(tree):
    """Per-layer views of a param subtree stacked on a leading layer (or
    period) axis: for each leaf, the tuple of its slices. One unbind per
    leaf, so the backward pass stacks the layers' gradients once
    (indexing layer by layer would build and add a full-size gradient
    per layer instead). A leaf's use plan passes to its slices."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = unbind_layers(v)
            continue
        out[k] = v.unbind(0)
        use = getattr(v, "_use", None)
        if use is not None:
            for t in out[k]:
                t._use = use.unstacked()
    return out


def layer_params(tree, i: int):
    """Layer (or period) i of a tree unbound by unbind_layers, each leaf
    fetched for its use. A model calls it inside the layer's recomputed
    region: a gathered layer is then gathered again in the backward
    pass rather than kept."""
    return {k: layer_params(v, i) if isinstance(v, dict) else fetch(v[i])
            for k, v in tree.items()}


def gelu(x):
    return F.gelu(x, approximate="tanh")


def silu(x):
    return F.silu(x)


ACTIVATIONS = {"gelu": gelu, "silu": silu, "relu": torch.relu}


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, *,
             gated: bool = True, use_bias: bool = False,
             dtype=torch.float32, lead: tuple = ()):
    kw = dict(use_bias=use_bias, dtype=dtype, lead=lead)
    p = {"up": dense_init(gen, d_model, d_ff, **kw),
         "down": dense_init(gen, d_ff, d_model, **kw)}
    if gated:
        p["gate"] = dense_init(gen, d_model, d_ff, **kw)
    return p


def mlp_apply(p, x, *, activation: str = "silu",
              compute_dtype=torch.bfloat16):
    act = ACTIVATIONS[activation]
    up = dense_apply(p["up"], x, compute_dtype)
    if "gate" in p:
        up = act(dense_apply(p["gate"], x, compute_dtype)) * up
    else:
        up = act(up)
    return dense_apply(p["down"], up, compute_dtype)
