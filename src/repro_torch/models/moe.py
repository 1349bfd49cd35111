"""Mixture-of-Experts FFN with top-k routing (port of repro/models/moe.py;
grok-1, granite-moe, jamba).

The same function as the JAX package's group-local capacity routing:

  * tokens are split into G groups: `groups`, or the ambient mesh's
    pod x data size (models/common.py: ambient_axis_size), halved while
    it does not divide the tokens, as the JAX package takes it; each
    group has its own capacity and positions. In a train step on a mesh a
    rank's block of the batch is its group, and the aux terms below are
    its parts of the whole batch's: the dispatch fraction (no gradient)
    summed over the data ranks, the router probabilities' and the
    entropy's means taken over the whole batch's tokens, so that the
    step's sum over the ranks gives the global terms;
  * the router runs in fp32 (the activations and the router kernel are
    upcast explicitly: under a bf16/fp16 policy the kernel is cast,
    since KEEP_FP32 does not match `router`, and JAX promotes the mixed
    einsum to fp32 where torch would refuse it), then softmax and top-k;
  * gates are the top-k probabilities over max(sum, 1e-9);
  * each (token, k) pair's position in its expert's buffer is the count
    of the group's pairs routed to that expert before it, in the
    flattened (token, k) order, token-major; a pair at position >= cap
    is dropped (weight 0), and padding (`valid` False) routes nowhere
    and takes no capacity. The count is one scan over the flat view of
    an expert-major (G, E, T * K) one-hot, each (group, expert) row less
    the running total of the rows before it (_capacity_route);
  * the aux terms are the load-balance loss (mean dispatch fraction x
    mean router probability x E / K) and the router entropy.

Ties in top-k go to the lower expert index, as `lax.top_k` does: the
port takes the first K of a stable descending sort (`torch.topk` does
not promise an order among equal values).

Expert compute. The reference scatters the kept pairs into a dense (G,
E, cap, d) buffer and runs every expert over all cap rows. Serving routes
dropless (cap = T * K), so a batched prefill would run E times the
expert work actually needed; the port therefore keeps the dense buffer
only while it is small (E * cap <= DENSE_ROWS rows: decode steps, one
batched product per weight, no host sync) and otherwise gathers each
expert's kept rows, sorted by expert, and runs that expert's MLP on
them alone (one host sync for the per-expert counts). Both are the
reference's function up to fp32 summation order, drops included.
chip_smoke.py's phase M(a) times both on granite-moe-3b-a800m's decode
step and on a batched prefill; each is faster where it is taken.

On a mesh whose model axis cuts the expert stacks (a train step:
distributed/sharding.py: use_plan), the model ranks of one data group
hold the same tokens and route them alike (the router is whole on every
rank). Each rank then runs its part of the experts (`experts_part`) on
the route one device would take: its E / m experts ("expert": its slice
of the dense buffer, or only its experts' gathered rows), or, where E
does not divide and the stacks are cut on their ff dim ("col" / "row"),
every expert's ff columns. The products are taken at fp32 at least from
operands rounded to the compute dtype (as models/common.py: dense_apply
splits a matmul), each rank combines its picks, and the combined parts
are summed over "model" in rank order; the input's and the gates'
gradients are summed over "model" (Megatron's f). No all-to-all is
needed, since the batch is cut over "data" only.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.metrics.spans import count, span
from repro_torch.models.common import (ACTIVATIONS, ambient,
                                       ambient_axis_size, dense_init,
                                       tp_kind)

# Largest E * cap for which the experts run over the dense (E, cap, d)
# buffer; above it each expert runs on its gathered rows. Set between a
# 4-slot granite decode step (1280) and a 4 x 64 prefill (81920), the
# sizes the routes were timed at; not tuned in between.
DENSE_ROWS = 4096


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    d_model: int
    d_ff: int
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    activation: str = "silu"
    gated: bool = True


def moe_init(gen: torch.Generator, cfg: MoeConfig, dtype=torch.float32,
             lead: tuple = ()):
    """Router (d, E) fp32 and (E, din, dout) expert stacks in `dtype`;
    `lead` prepends stacking dims (the decoder's periods)."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    dev = None if gen is None else gen.device

    def expert_stack(din, dout):
        w = torch.randn((*lead, e, din, dout), generator=gen, device=dev)
        return (w * (1.0 / math.sqrt(din))).to(dtype)

    p = {"router": dense_init(gen, d, e, dtype=torch.float32, lead=lead),
         "up": expert_stack(d, f),
         "down": expert_stack(f, d)}
    if cfg.gated:
        p["gate"] = expert_stack(d, f)
    return p


def _top_k(probs, k: int):
    """(values, indices) of the k largest along the last dim, the lower
    index first among equal values (lax.top_k's order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _capacity_route(idx_k, E: int, cap: int, valid=None):
    """Each (token, k) pair's place in its expert's buffer, group by
    group: idx_k (G, Tl, K) the picked experts, valid (G, Tl) or None.
    Returns flat_e (G, Tl * K), each pair's expert; pos_k, the count of
    the group's pairs routed to that expert before it, token-major
    (unused at a pad); keep, pos_k < cap and not a pad; and density (E,),
    the share of tokens routed to each expert. Pads route nowhere.

    The one-hot is expert-major, (G, E, Tl * K), behind one zero, so one
    scan over its flat view counts the pairs before each flat index (on
    CUDA a device-wide scan; a token-dim scan of a (G, Tl * K, E) one-hot
    gives each expert column one thread); each row's count at its start
    is taken off. A comparison makes the one-hot, the same ops on every
    device (the CPU's one_hot kernel also checks its input's range)."""
    G, Tl, K = idx_k.shape
    L = Tl * K
    flat_e = idx_k.reshape(G, L)
    routed = flat_e
    if valid is not None:
        valid_k = valid.repeat_interleave(K, dim=1)
        routed = torch.where(valid_k, flat_e, E)             # pads: nowhere
    onehot = flat_e.new_zeros(1 + G * E * L)
    sel = onehot[1:].view(G, E, L)
    torch.eq(routed[:, None, :],
             torch.arange(E, device=flat_e.device)[:, None], out=sel)
    before = torch.cumsum(onehot, 0)[:-1]
    pos_k = (torch.gather(before.view(G, E, L), 1, flat_e[:, None])[:, 0]
             - torch.gather(before[::L].view(G, E), 1, flat_e))
    keep = pos_k < cap
    if valid is not None:
        keep = keep & valid_k
    density = sel.view(G, E, Tl, K).any(-1).mean(dim=(0, 2),
                                                 dtype=torch.float32)
    return flat_e, pos_k, keep, density


def _expert_mlp(p, cfg: MoeConfig, x, e, compute_dtype):
    """Expert e's MLP on rows x (n, d); e an int, or None for every
    expert at once over x (E, n, d)."""
    sl = slice(None) if e is None else e
    act = ACTIVATIONS[cfg.activation]
    up = torch.matmul(x, p["up"][sl].to(compute_dtype))
    if cfg.gated:
        up = act(torch.matmul(x, p["gate"][sl].to(compute_dtype))) * up
    else:
        up = act(up)
    return torch.matmul(up, p["down"][sl].to(compute_dtype))


def moe_apply(p, cfg: MoeConfig, x, *, valid=None,
              compute_dtype=torch.bfloat16, groups=None):
    """x (B, S, d) -> (out (B, S, d) in x's dtype, aux {moe_aux_loss,
    router_entropy}). valid: optional (B, S) bool; False tokens (left
    padding) route nowhere, take no capacity and produce 0. groups: the
    routing groups of x (default: the ambient pod x data size over the
    blocks the batch is cut into, 1 off a mesh)."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    amb = ambient()
    blocks = 1 if amb is None else amb.blocks
    G = groups if groups is not None else max(
        1, ambient_axis_size("pod") * ambient_axis_size("data") // blocks)
    while T % G:
        G //= 2
    G = max(G, 1)
    Tl = T // G
    cap = max(1, int(cfg.capacity_factor * Tl * K / E))

    xg = x.reshape(G, Tl, d)
    with span("model.moe.route"):
        router_logits = torch.matmul(xg.float(),
                                     p["router"]["kernel"].float())
        probs = torch.softmax(router_logits, dim=-1)         # (G, Tl, E)
        gates_k, idx_k = _top_k(probs, K)                    # (G, Tl, K)
        gates_k = gates_k / torch.clamp(gates_k.sum(-1, keepdim=True),
                                        min=1e-9)

        flat_e, pos_k, keep, density = _capacity_route(
            idx_k, E, cap, None if valid is None else valid.reshape(G, Tl))
        density_proxy = probs.mean(dim=(0, 1))
        entropy = -(probs * torch.log(probs + 1e-9)).sum(-1).mean()
        if blocks > 1:
            # a block of the batch (equal blocks): the global dispatch
            # fraction, and this block's shares of the global means
            density = amb.data_sum(density) / blocks
            density_proxy = density_proxy / blocks
            entropy = entropy / blocks
        aux_loss = torch.sum(density * density_proxy) * (E / K)

    padded = valid is not None
    with span("model.moe.experts"):
        if tp_kind(p["up"]) is not None:
            out = _split_experts(p, cfg, xg, gates_k.reshape(G, Tl * K),
                                 flat_e, pos_k, keep, cap, compute_dtype,
                                 padded=padded)
        else:
            out = _experts(p, cfg, xg.to(compute_dtype),
                           gates_k.reshape(G, Tl * K).to(compute_dtype),
                           flat_e, pos_k, keep, cap, 0, compute_dtype,
                           padded=padded)
    out = out.reshape(B, S, d)
    return out.to(x.dtype), {"moe_aux_loss": aux_loss,
                             "router_entropy": entropy}


def _experts(p, cfg: MoeConfig, x, gates, flat_e, pos_k, keep, cap: int,
             first: int, compute_dtype, padded: bool = False):
    """The combined expert outputs (G, Tl, d) of the routed pairs: x (G,
    Tl, d) the group's rows, gates (G, Tl * K) and flat_e, pos_k, keep
    the pairs' gates, experts, buffer positions and kept flags. The
    experts of p's stacks are [first, first + El), El their count; a
    pair routed to another expert adds nothing. The route is one
    device's: the dense (El, cap) buffer while E * cap <= DENSE_ROWS,
    else each expert on its gathered rows, whose counts also give the
    counters of routed and dropped pairs where p holds every expert and
    no pair is padding (`padded` False; metrics/spans.py)."""
    G, Tl, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    El = p["up"].shape[0]
    local = flat_e - first
    mine = keep & (local >= 0) & (local < El)
    x_rep = x.repeat_interleave(K, dim=1)                # (G, TlK, d)
    if E * cap <= DENSE_ROWS:
        # the reference's dense buffer: kept pairs at (expert, position),
        # dropped ones (and other ranks') in an overflow row that is cut
        # off
        e_idx = torch.where(mine, local, 0)
        pos_c = torch.where(mine, pos_k, cap)
        buf = torch.zeros((G, El, cap + 1, d), dtype=x.dtype,
                          device=x.device)
        g_idx = torch.arange(G, device=x.device)[:, None].expand_as(flat_e)
        buf.index_put_((g_idx, e_idx, pos_c), x_rep, accumulate=True)
        yout = _expert_mlp(p, cfg, buf[:, :, :cap], None, compute_dtype)
        y_tk = yout[g_idx, e_idx, torch.clamp(pos_c, max=cap - 1)]
    else:
        # each expert on its own kept rows, sorted by expert (dropped
        # pairs sort last, under key El, and are never computed)
        key = torch.where(mine, local, El).reshape(-1)
        order = torch.argsort(key, stable=True)
        counts = _expert_counts(key, El, E)
        if El == E and not padded and key.device.type != "meta":
            count("moe.pairs_routed", key.numel())
            count("moe.pairs_dropped", counts[El])
        rows = x_rep.reshape(-1, d)[order]
        y_sorted = torch.zeros_like(rows)
        start = 0
        for e, n in enumerate(counts[:El]):
            if n:
                y_sorted[start:start + n] = _expert_mlp(
                    p, cfg, rows[start:start + n], e, compute_dtype)
                start += n
        y_tk = y_sorted[torch.argsort(order)].reshape(G, Tl * K, d)
    w = gates * mine.to(gates.dtype)
    return (y_tk * w[..., None]).reshape(G, Tl, K, d).sum(dim=2)


def _expert_counts(key, El: int, E: int) -> list:
    """The rows of each of the El local experts (and, last, the dropped
    pairs) under the sort key. On a meta tensor (the dry run: no data)
    the pairs are taken as routed evenly over the E experts, none
    dropped: each local expert gets key.numel() // E of them."""
    if key.device.type == "meta":
        each = key.numel() // E
        return [each] * El + [key.numel() - each * El]
    with span("sync.moe_counts"):
        counts = torch.bincount(key, minlength=El + 1).tolist()
    count("sync.moe_counts")
    return counts


def experts_part(p, cfg: MoeConfig, x, gates, flat_e, pos_k, keep,
                 cap: int, first: int, compute_dtype, padded: bool = False):
    """One model rank's part of the combined expert outputs (_experts):
    p its expert stacks (its E / m experts from `first`, or every
    expert's ff columns with first 0), taken at x's dtype (fp32 at
    least) from their values rounded to compute_dtype."""
    stacks = {k: p[k].to(compute_dtype).to(x.dtype)
              for k in ("up", "gate", "down") if k in p}
    return _experts(stacks, cfg, x, gates, flat_e, pos_k, keep, cap, first,
                    x.dtype, padded)


def _split_experts(p, cfg: MoeConfig, xg, gates, flat_e, pos_k, keep,
                   cap: int, compute_dtype, padded: bool = False):
    """The combined expert outputs on a model axis that cuts the expert
    stacks: this rank's experts_part, summed over "model" in rank order
    and rounded to compute_dtype once; xg's and the gates' gradients are
    summed over "model"."""
    import torch.distributed as dist
    from repro_torch.distributed import partial
    group = ambient().group("model")
    acc = torch.promote_types(compute_dtype, torch.float32)
    x = partial.copy_to_model(xg.to(compute_dtype).to(acc), group)
    gates = partial.copy_to_model(gates.to(compute_dtype).to(acc), group)
    first = (dist.get_rank(group) * p["up"].shape[0]
             if tp_kind(p["up"]) == "expert" else 0)
    part = experts_part(p, cfg, x, gates, flat_e, pos_k, keep, cap, first,
                        compute_dtype, padded)
    return partial.reduce_from_model(part, group).to(compute_dtype)
