"""One rank of the port's mesh train-step tests (test_torch_mesh_train.py
on the CPU, test_torch_cuda_kernels.py on four cards), and what they
share: the cases, the one-device and mesh runs, and the comparison.

`run_rank` is started with the spawn method, one process per rank, over a
process group whose rendezvous is a FileStore (no TCP port): gloo on the
CPU, or NCCL with rank r on card r. It builds the mesh of one layout
and, for every case of the inputs file, runs the placed train step from
the given params over the given batches, then writes what it saw
(losses, the params gathered whole, the partial all-reduces of each
step) for the parent to compare. It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

LR = 1e-3
STEPS = 3
# name: (arch, optimizer, microbatches)
CASES = {
    "bert-fused_lans": ("bert-large", "fused_lans", 1),
    "bert-fused_mixed_lans": ("bert-large", "fused_mixed_lans", 1),
    "bert-fused_lamb": ("bert-large", "fused_lamb", 1),
    "bert-lans": ("bert-large", "lans", 1),
    "qwen-fused_lans": ("qwen2.5-14b", "fused_lans", 2),
    "granite-fused_lans": ("granite-moe-3b-a800m", "fused_lans", 1),
    "whisper-fused_lans": ("whisper-large-v3", "fused_lans", 1),
    "mamba2-fused_lans": ("mamba2-130m", "fused_lans", 1),
    "bert-adamw": ("bert-large", "adamw", 1),
    "qwen_kv1-fused_lans": ("qwen2.5-14b:kv1", "fused_lans", 1),
}
# cases run on the model axis only (1 x 2 under gloo, every four-card
# layout): a hybrid with MoE experts over "model", Mamba-2 mixers cut on
# heads and a vocab-parallel readout; a tied, soft-capped readout, also
# through the chunked loss; MoE whose experts do not divide over the
# model ranks, cut on their ff dim
SPLIT_CASES = {
    "jamba-fused_lans": ("jamba-1.5-large-398b", "fused_lans", 1),
    "gemma2-fused_lans": ("gemma2-2b", "fused_lans", 1),
    "gemma2_chunk-fused_lans": ("gemma2-2b:chunk16", "fused_lans", 1),
    "granite_e5-fused_lans": ("granite-moe-3b-a800m:e5", "fused_lans", 1),
}
ALL_CASES = {**CASES, **SPLIT_CASES}
# reduced archs with a config changed: name -> (arch, reduced_decoder's
# fields). kv1: one KV head, so that n_kv * head_dim divides over two
# model ranks but n_kv does not: attention in one head group of both
# ranks (sharding.head_groups: wq / wk / wv gathered over it, each rank
# its rows of wo; the MLP split too); e5: five experts;
# chunk16: the reduced arch, its loss chunked (CHUNKED)
VARIANTS = {"qwen2.5-14b:kv1": ("qwen2.5-14b", {"n_kv_heads": 1}),
            "granite-moe-3b-a800m:e5": ("granite-moe-3b-a800m",
                                        {"n_experts": 5}),
            "gemma2-2b:chunk16": ("gemma2-2b", {})}
# arch name -> positions per chunk of its chunked_lm_loss, in place of
# the arch's own rule (which chunks only at vocab >= 65536, seq >= 1024)
CHUNKED = {"gemma2-2b:chunk16": 16}
# seq of the batches: a multiple of the reduced Mamba-2 chunk (16),
# within whisper's reduced max_target (64)
SEQ = 32


def make_tx(name):
    """(transform, policy name) of a case's optimizer."""
    from repro_torch.core.optim import adamw, fused_lamb, fused_lans, lans
    from repro_torch.precision import fused_mixed_lans, get_policy
    if name == "fused_mixed_lans":
        return fused_mixed_lans(LR, get_policy("bf16")), "bf16"
    return {"fused_lans": fused_lans, "fused_lamb": fused_lamb,
            "lans": lans, "adamw": adamw}[name](LR), "fp32"


def reduced(arch_name):
    """The port's reduced arch of a case (VARIANTS applied)."""
    from repro_torch.configs import get_arch, reduced_arch, reduced_decoder
    base, over = VARIANTS.get(arch_name, (arch_name, {}))
    if not over:
        return reduced_arch(base)
    arch = get_arch(base)
    return dataclasses.replace(arch, cfg=reduced_decoder(arch.cfg, **over))


def loss_of(arch_name, arch):
    """The loss a case trains: the arch's own, or for a CHUNKED arch the
    decoder's loss through chunked_lm_loss at its chunk (as Arch.loss_fn
    takes it, the embedding and readout fetched once)."""
    chunk = CHUNKED.get(arch_name)
    if chunk is None:
        return arch.loss_fn
    from repro_torch.models import decoder as dec_lib
    from repro_torch.models.common import WHOLE, fetch_tree

    def loss_fn(params, batch):
        whole = batch.get(WHOLE)
        count = None if whole is None else (whole["labels"] != -100).sum()
        params = {**params, **{k: fetch_tree(params[k]) for k in
                               ("embed", "lm_head") if k in params}}
        hidden, _, aux = dec_lib.decoder_apply(
            params, arch.cfg, batch["tokens"], return_hidden=True)
        loss = dec_lib.chunked_lm_loss(
            params, arch.cfg, hidden, batch["labels"], chunk=chunk,
            moe_aux=aux["moe_aux_loss"], count=count)
        return loss, {"router_entropy": aux["router_entropy"]}

    return loss_fn


def case_arch(arch_name, policy):
    """The reduced arch, computing in fp32 (bf16 under the bf16 policy)."""
    from repro_torch.precision import get_policy
    arch = reduced(arch_name)
    cfg = (dataclasses.replace(arch.cfg, compute_dtype=torch.float32)
           if policy == "fp32" else get_policy(policy).apply_to_cfg(arch.cfg))
    return dataclasses.replace(arch, cfg=cfg)


def is_moe(case_name):
    return getattr(reduced(ALL_CASES[case_name][0]).cfg, "n_experts", 0) > 0


def splits_matmuls(layout):
    """A layout with a model axis: the use plan splits the matmuls of
    the leaves cut over it, which changes the order of their sums."""
    return layout["model"] > 1


def early_paths(params, data, model=1):
    """The paths of the leaves a zero3 mesh of `data` x `model` cuts over
    "data": their gradients are summed over the data ranks in the
    backward pass, once per microbatch (distributed/steps.py)."""
    import types
    from repro_torch.core.optim.base import tree_items
    from repro_torch.distributed import sharding as shd
    mesh = types.SimpleNamespace(shape={"data": data, "model": model})
    spec = shd.params_pspec(params, mesh, zero3=True)
    return frozenset(p for p, s in tree_items(spec)
                     if any("data" in (e if isinstance(e, tuple) else (e,))
                            for e in s))


class _SimUse:
    """A model-axis use plan on one device (mesh_order): the fetch hands
    the whole leaf on, marked with `kind` for the splits below."""
    gathered = ()
    segments = ()
    groups = 0

    def __init__(self, kind):
        self.kind = kind

    def unstacked(self):
        return self


def sim_uses(params, data, model, heads, zero3=False, mamba=None):
    """{path: _SimUse or None} of `params`: the leaves a mesh of `data` x
    `model` computes on as their model shards (distributed/sharding.py:
    use_plan)."""
    import types
    from repro_torch.core.optim.base import tree_map, tree_paths
    from repro_torch.distributed import sharding as shd
    mesh = types.SimpleNamespace(shape={"data": data, "model": model})
    spec = shd.params_pspec(params, mesh, zero3=zero3)

    def sim(path, s):
        use = shd.use_plan(path, s, mesh, heads, mamba)
        return _SimUse(use.kind) if use and use.kind != "gather" else None

    return tree_map(sim, tree_paths(params), spec)


class _RankCopies(torch.autograd.Function):
    """n copies of x; the backward pass adds their gradients in rank
    order."""

    @staticmethod
    def forward(ctx, x, n):
        return tuple(x.clone() for _ in range(n))

    @staticmethod
    def backward(ctx, *grads):
        total = grads[0]
        for g in grads[1:]:
            total = total + g
        return total, None


def split_dense(plain, model):
    """dense_apply (models/common.py) as `model` ranks compute a
    tensor-parallel kernel's product on one device: each rank's columns
    (and bias slice) on their own, or each rank's rows' product, summed
    in rank order in fp32 at least before the one rounding; x's gradient
    the ranks' parts added in rank order too. A vocab-cut lm_head is
    column parallel, its logits marked vocab-parallel. Any other kernel
    as `plain` has it."""
    from repro_torch.models.common import tp_kind

    def dense(p, x, compute_dtype=torch.bfloat16):
        kind = tp_kind(p["kernel"])
        if kind is None:
            return plain(p, x, compute_dtype)
        acc = torch.promote_types(compute_dtype, torch.float32)
        x = x.to(compute_dtype).to(acc)
        w = p["kernel"].to(compute_dtype).to(acc)
        b = p.get("bias")
        if kind == "rank":
            # one rank's projection of a head group (split_attention):
            # its own copy of x, made at the first rank's call
            ranks = p["kernel"]._ranks
            copies = ranks["copies"]
            if ranks["key"] not in copies:
                copies[ranks["key"]] = _RankCopies.apply(x, model)
            y = torch.matmul(copies[ranks["key"]][ranks["rank"]], w).to(
                compute_dtype)
            return y if b is None else y + b.to(compute_dtype)
        if kind == "part":
            # one rank's rows of wo on its slice of its group's output:
            # the part, unrounded, for split_attention to add
            n = w.shape[-2]
            j = p["kernel"]._slot
            return torch.matmul(x[..., j * n:(j + 1) * n], w)
        if kind in ("col", "vocab"):
            # one copy of x per rank, whose gradients are added in rank
            # order before the other layers' uses of x add theirs, as
            # copy_to_model adds them on the mesh
            ys = [torch.matmul(x_r, w_r).to(compute_dtype) for x_r, w_r in
                  zip(_RankCopies.apply(x, model), w.chunk(model, -1))]
            if b is not None:
                ys = [y + b_r.to(compute_dtype)
                      for y, b_r in zip(ys, b.chunk(model, -1))]
            y = torch.cat(ys, -1)
            if kind == "vocab":
                y._vocab = True
            return y
        parts = [torch.matmul(x_r, w_r) for x_r, w_r in
                 zip(x.chunk(model, -1), w.chunk(model, -2))]
        y = parts[0]
        for part in parts[1:]:
            y = y + part
        y = y.to(compute_dtype)
        return y if b is None else y + b.to(compute_dtype)

    return dense


def _in_rank_order(parts):
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def split_vocab(model):
    """The vocab-parallel pieces of models/common.py as `model` ranks
    compute them, on one device: {name: function} of _vocab_lookup,
    _vocab_readout and _vocab_log_likelihood. The lookup is one device's
    (each id's row from its one rank, the others adding zero); the
    readout gives each rank's columns from its rows of the table (x's
    gradient the ranks' parts in rank order, each rank its slice of the
    bias); the log-likelihood takes the max over every column, each
    rank's sum of exponentials over its columns, the sums added in rank
    order, and the label's logit from its rank."""

    def lookup(table, ids, compute_dtype):
        return table[ids.long()].to(compute_dtype)

    def readout(table, x, compute_dtype, bias=None):
        acc = torch.promote_types(compute_dtype, torch.float32)
        xs = _RankCopies.apply(x.to(compute_dtype).to(acc), model)
        ys = [torch.matmul(x_r, t_r.to(compute_dtype).to(acc).t()).to(
            compute_dtype) for x_r, t_r in zip(xs, table.chunk(model, 0))]
        if bias is not None:
            ys = [y.float() + b_r.float()
                  for y, b_r in zip(ys, bias.chunk(model, 0))]
        y = torch.cat(ys, -1)
        y._vocab = True
        return y

    def log_likelihood(logits, labels):
        zs = [z.contiguous() for z in logits.float().chunk(model, -1)]
        n = zs[0].shape[-1]
        with torch.no_grad():
            top = torch.stack([z.amax(-1, keepdim=True) for z in zs]).amax(0)
        total = _in_rank_order([torch.exp(z - top).sum(-1) for z in zs])
        picks = []
        for r, z in enumerate(zs):
            local = labels.long() - r * n
            mine = (local >= 0) & (local < n)
            picks.append(torch.gather(
                z, -1, torch.where(mine, local, 0)[..., None])[..., 0] * mine)
        return _in_rank_order(picks) - top[..., 0] - torch.log(total)

    return {"_vocab_lookup": lookup, "_vocab_readout": readout,
            "_vocab_log_likelihood": log_likelihood}


def split_experts(model):
    """models/moe.py's _split_experts as `model` ranks compute it, on one
    device: each rank's experts_part from its chunk of the stacks (its
    experts, or every expert's ff columns), on its own copy of the rows
    and the gates (their gradients added in rank order), the parts added
    in rank order before the one rounding."""
    from repro_torch.models import moe
    from repro_torch.models.common import tp_kind

    def experts(p, cfg, xg, gates, flat_e, pos_k, keep, cap, compute_dtype,
                padded=False):
        acc = torch.promote_types(compute_dtype, torch.float32)
        xs = _RankCopies.apply(xg.to(compute_dtype).to(acc), model)
        gs = _RankCopies.apply(gates.to(compute_dtype).to(acc), model)
        by_expert = tp_kind(p["up"]) == "expert"
        dims = {k: 0 if by_expert else (-2 if k == "down" else -1)
                for k in ("up", "gate", "down") if k in p}
        parts = []
        for r in range(model):
            stacks = {k: p[k].chunk(model, d)[r].contiguous()
                      for k, d in dims.items()}
            first = r * stacks["up"].shape[0] if by_expert else 0
            parts.append(moe.experts_part(stacks, cfg, xs[r], gs[r], flat_e,
                                          pos_k, keep, cap, first,
                                          compute_dtype, padded))
        return _in_rank_order(parts).to(compute_dtype)

    return experts


def split_mamba(model):
    """models/mamba2.py's _mamba_split as `model` ranks compute it (its
    output and no cache), on one device: each rank's in_proj and conv_w columns and conv bias
    channels taken from its own copy of the leaf (the ranks' gradients
    of the columns they share, B and C, added in rank order), its heads'
    slices of the small leaves, the mixer on its heads, the sums of
    squares of the gated norm added in rank order (each rank's copy's
    gradient too), and out_proj's row parts added in rank order."""
    from repro_torch.distributed.sharding import (mamba_segments,
                                                  segment_columns)
    from repro_torch.models import mamba2

    def mixer(p, cfg, x, valid, compute_dtype, cache=None):
        assert cache is None            # training: no cache
        acc = torch.promote_types(compute_dtype, torch.float32)
        lc = mamba2.local_cfg(cfg, model)
        xs = _RankCopies.apply(x.to(compute_dtype).to(acc), model)
        ks = _RankCopies.apply(p["in_proj"]["kernel"], model)
        ws = _RankCopies.apply(p["conv_w"], model)
        bs = _RankCopies.apply(p["conv_b"], model)
        ys = []
        for r in range(model):
            cols, chans = (torch.as_tensor(segment_columns(
                mamba_segments(leaf, cfg, model), model, r), device=x.device)
                for leaf in ("in_proj", "conv_w"))
            w = ks[r].index_select(-1, cols).to(compute_dtype).to(acc)
            proj = torch.matmul(xs[r], w).to(compute_dtype)
            heads = [p[k].chunk(model)[r] for k in ("dt_bias", "A_log", "D")]
            y, _ = mamba2._ssm(lc, proj, ws[r].index_select(-1, chans),
                               bs[r].index_select(0, chans), *heads,
                               compute_dtype, valid)
            ys.append(y)
        totals = _RankCopies.apply(
            _in_rank_order([mamba2.sum_sq(y) for y in ys]), model)
        parts = []
        for r, y in enumerate(ys):
            h = mamba2.gated_norm(y, totals[r], cfg.d_inner,
                                  p["norm"]["scale"].chunk(model)[r])
            w = p["out_proj"]["kernel"].chunk(model, 0)[r]
            parts.append(torch.matmul(h.to(compute_dtype).to(acc),
                                      w.to(compute_dtype).to(acc)))
        return _in_rank_order(parts).to(compute_dtype).to(x.dtype), None

    return mixer


def split_attention(plain, model):
    """models/attention.py's attn_apply as `model` ranks compute an
    attention block cut in head groups (a "heads" wq:
    distributed/sharding.py: head_groups), on one device (training: no
    cache). Rank k of group g = k // (model / d) runs `plain` on its own
    copies of the leaves: its group's columns of wq / wk / wv (and
    biases), and the QK-norm scales, each projection of x from its own
    copy of the input (split_dense's "rank": the copies' gradients added
    in rank order, as copy_to_model adds them), and its rows of wo on
    its slice of the group's output (split_dense's "part"); the parts
    added in rank order in fp32 before the one rounding. A leaf's
    copies' gradients add up in rank order too, as the ranks' parts of
    it are summed on the mesh (the group's reduce-scatter, the biases'
    and scales' sums over "model")."""
    from repro_torch.distributed.sharding import head_groups
    from repro_torch.models.common import tp_kind

    def attn(p, cfg, x, *, compute_dtype=torch.bfloat16, **kw):
        if tp_kind(p["wq"]["kernel"]) != "heads":
            return plain(p, cfg, x, compute_dtype=compute_dtype, **kw)
        assert kw.get("cache") is None and kw.get("kv_cache") is None
        d = head_groups((cfg.n_heads, cfg.n_kv_heads, cfg.head_dim), model)
        r = model // d
        copies = {(k, leaf): _RankCopies.apply(p[k][leaf], model)
                  for k in p for leaf in p[k] if k != "wo"}
        shared = {}
        parts = []
        for rank in range(model):
            g, j = divmod(rank, r)
            pk = {k: {"scale": copies[k, "scale"][rank]}
                  for k in ("q_norm", "k_norm") if k in p}
            for k in ("wq", "wk", "wv"):
                w = copies[k, "kernel"][rank].chunk(d, -1)[g].contiguous()
                w._tp, w._ranks = "rank", dict(copies=shared, key=k,
                                                rank=rank)
                pk[k] = {"kernel": w}
                if (k, "bias") in copies:
                    pk[k]["bias"] = copies[k, "bias"][rank].chunk(d, -1)[g]
            wo = p["wo"]["kernel"].chunk(model, -2)[rank]
            wo._tp, wo._slot = "part", j
            pk["wo"] = {"kernel": wo}
            part, _ = plain(pk, cfg, x, compute_dtype=compute_dtype, **kw)
            parts.append(part)
        return _in_rank_order(parts).to(compute_dtype), None

    return attn


@contextlib.contextmanager
def model_split(model):
    """While active, the models compute as `model` ranks split them, on
    one device: dense layers by split_dense, attention cut in head
    groups by split_attention, the vocab by split_vocab, MoE experts by
    split_experts and Mamba mixers by split_mamba."""
    import sys
    from repro_torch.models import attention, common, mamba2, moe
    plain = common.dense_apply
    mods = [m for name, m in sys.modules.items()
            if name.startswith("repro_torch.models")
            and getattr(m, "dense_apply", None) is plain]
    patches = [(m, "dense_apply", split_dense(plain, model)) for m in mods]
    attn = split_attention(attention.attn_apply, model)
    patches += [(m, "attn_apply", attn) for name, m in sys.modules.items()
                if name.startswith("repro_torch.models")
                and m is not attention
                and getattr(m, "attn_apply", None) is attention.attn_apply]
    patches += [(common, k, f) for k, f in split_vocab(model).items()]
    patches += [(moe, "_split_experts", split_experts(model)),
                (mamba2, "_mamba_split", split_mamba(model))]
    saved = [(m, k, getattr(m, k)) for m, k, _ in patches]
    for m, k, f in patches:
        setattr(m, k, f)
    try:
        yield
    finally:
        for m, k, f in saved:
            setattr(m, k, f)


@contextlib.contextmanager
def mesh_order(data, microbatches, early=frozenset(), model=1, heads=None,
               zero3=False, mamba=None):
    """While active, a one-device step built with microbatches=1 takes its
    gradient in the order of a mesh of `data` x `model` ranks whose batch
    is cut over the data ranks (distributed/steps.py): each rank's block
    of each microbatch on its own, its losses' means over the whole
    microbatch (WHOLE); a rank's microbatches summed and divided by their
    number, as the step sums them; then the ranks' sums added, as the
    all-reduce adds them (exactly: a sum of two is the same in either
    order). The leaves at the paths in `early` (cut over data:
    early_paths) are summed as a zero3 mesh sums them, over the ranks in
    each microbatch's backward pass in the leaf's dtype, then over the
    microbatches in fp32. The leaves a mesh with a model axis splits
    (sim_uses, from `heads` and `mamba`) are split as its ranks split
    them (model_split), the ranks' parts added in rank order, as the
    mesh adds them (distributed/partial.py). The models see the
    mesh's data axis (models/common.py: Ambient), so that MoE routes each
    block as its group; the dispatch fractions the mesh sums over the
    ranks are taken from a forward pass of every block first. The maths is
    one device's; only the order of the gradient's sums is the mesh's, so
    that a mesh run can be held to it element by element."""
    import types
    from repro_torch.core.optim.base import tree_items, tree_map
    from repro_torch.distributed import steps
    from repro_torch.models.common import WHOLE, Ambient, ambient_mesh
    plain = steps.loss_and_grads
    mesh = types.SimpleNamespace(shape={"data": data, "model": model})
    cut = ("data",)

    @dataclasses.dataclass
    class Block(Ambient):
        """The ambient mesh of one rank's block: the stand-in mesh, whose
        sum over the data ranks `look` gives."""
        look: object = None

        def data_sum(self, t):
            return self.look(t)

    def marked(loss_fn, params):
        """loss_fn, its live leaves marked as the mesh uses them."""
        if model == 1:
            return loss_fn
        uses = sim_uses(params, data, model, heads, zero3, mamba)

        def fn(live, b):
            tree_map(steps._mark, live, uses)
            return loss_fn(live, b)
        return fn

    def blocks(batch, n):
        size = next(iter(batch.values())).shape[0] // n
        return [{k: v[i * size:(i + 1) * size] if v.ndim else v
                 for k, v in batch.items()} for i in range(n)]

    def add(a, b):
        return tree_map(torch.add, a, b) if isinstance(a, dict) else a + b

    def densities(loss_fn, params, mbs):
        """{(microbatch, rank): (local, global) dispatch fractions of each
        MoE call in forward order}, from a forward pass of every block
        (no MoE: empty lists)."""
        local = {}
        for i, mb in enumerate(mbs):
            for r, blk in enumerate(blocks(mb, data)):
                seen = local[i, r] = []
                record = lambda d, seen=seen: seen.append(d.clone()) or d
                with torch.no_grad(), ambient_mesh(
                        Block(mesh, cut, record)):
                    # detached leaves: marked() marks the leaves it is
                    # handed, and the params are the caller's
                    loss_fn(tree_map(torch.Tensor.detach, params),
                            {**blk, WHOLE: mb})
                if not seen:
                    return {}
        out = {}
        for (i, r), seen in local.items():
            total = []
            for k in range(len(seen)):
                t = local[i, 0][k]
                for q in range(1, data):
                    t = t + local[i, q][k]
                total.append(t)
            out[i, r] = list(zip(seen, total))
        return out

    def summed(table):
        """data_sum for a block: the global fraction of the MoE call whose
        local fraction is `d` (equal local fractions of two calls must
        agree on it)."""
        def look(d):
            hits = {id(g): g for l, g in table if torch.equal(l, d)}
            assert len(hits) == 1, "ambiguous or unseen dispatch fractions"
            return next(iter(hits.values())).clone()
        return look

    def in_mesh_order(loss_fn, params, batch, scale):
        loss_fn = marked(loss_fn, params)
        mbs = blocks(batch, microbatches)
        table = densities(loss_fn, params, mbs)
        runs = []                  # runs[i][r]: microbatch i, rank r
        for i, mb in enumerate(mbs):
            runs.append([])
            for r, blk in enumerate(blocks(mb, data)):
                look = summed(table[i, r]) if table else None
                with ambient_mesh(Block(mesh, cut, look)):
                    runs[i].append(plain(loss_fn, params, {**blk, WHOLE: mb},
                                         scale))
        loss = aux = grads = None
        for r in range(data):
            rr = [run[r] for run in runs]
            if microbatches == 1:
                loss_r, aux_r, grads_r = rr[0]
            else:
                grads_r = rr[0][2]
                for _, _, g in rr[1:]:
                    grads_r = add(grads_r, g)
                auxs = [a for _, a, _ in rr]
                aux_r = {k: torch.stack([a[k] for a in auxs]).mean(dim=0)
                         if torch.is_tensor(v) and v.is_floating_point()
                         else v for k, v in auxs[-1].items()}
                loss_r = (torch.stack([l for l, _, _ in rr]).sum()
                          / microbatches)
                grads_r = tree_map(lambda g: g / microbatches, grads_r)
            if grads is None:
                loss, aux, grads = loss_r, aux_r, grads_r
                continue
            loss, grads = loss + loss_r, add(grads, grads_r)
            aux = {k: v + aux_r[k] if torch.is_tensor(v)
                   and v.is_floating_point() else v for k, v in aux.items()}
        if early:
            dtypes = {p: t.dtype for p, t in tree_items(params)}
            flat = [[dict(tree_items(g)) for _, _, g in run] for run in runs]
            fixed = {}
            for path in early:
                total, dt = None, dtypes[path]
                for run in flat:
                    # the reduce-scatter sums the ranks' gradients in the
                    # leaf's dtype, before the step takes them to fp32
                    s = run[0][path].to(dt)
                    for r in range(1, data):
                        s = s + run[r][path].to(dt)
                    total = s.float() if total is None else total + s.float()
                fixed[path] = (total / microbatches if microbatches > 1
                               else total)
            grads = tree_map(lambda pth, g: fixed.get(pth, g),
                             _paths(grads), grads)
        return loss, aux, grads

    steps.loss_and_grads = in_mesh_order
    try:
        with model_split(model) if model > 1 else contextlib.nullcontext():
            yield
    finally:
        steps.loss_and_grads = plain


def _paths(tree):
    from repro_torch.core.optim.base import tree_paths
    return tree_paths(tree)


@contextlib.contextmanager
def groups_of(data):
    """While active, MoE routes a whole batch in `data` groups, as a mesh
    of `data` ranks does (the one-device step at the mesh's maths)."""
    import types
    from repro_torch.models.common import Ambient, ambient_mesh
    with ambient_mesh(Ambient(types.SimpleNamespace(shape={"data": data}))):
        yield


def recording(tx, seen):
    """tx, with every gradient its update is handed appended to `seen`,
    gathered whole (a collective on a mesh: every rank records)."""
    def update(grads, state, params=None):
        seen.append(whole_tree(grads))
        return tx.update(grads, state, params)
    return tx._replace(update=update)


def one_device_step(case, data=1, *, order=True, early=frozenset(),
                    seen=None, model=1, zero3=False):
    """The case's one-device step, (params, state, batch) -> (params,
    state, metrics). On a `data` x `model` mesh's behalf (either > 1): its
    gradient summed in that mesh's order (mesh_order, `early` its leaves
    summed per microbatch, the matmuls split as the mesh with or without
    zero3 splits them), or with order=False (model 1) in the plain order,
    MoE routing in the mesh's `data` groups (groups_of). With `seen`,
    each gradient its optimizer is handed is appended to it."""
    from repro_torch.distributed.steps import build_train_step
    tx, policy = make_tx(case["optimizer"])
    if seen is not None:
        tx = recording(tx, seen)
    arch = case_arch(case["arch"], policy)
    mb = case["microbatches"]
    meshed = data > 1 or model > 1
    step, _ = build_train_step(loss_of(case["arch"], arch), tx,
                               microbatches=1 if meshed and order else mb,
                               policy=policy)
    if not meshed:
        return step

    def in_mesh_order(params, state, batch):
        with (mesh_order(data, mb, early, model, arch.heads, zero3,
                         arch.mamba) if order
              else groups_of(data)):
            return step(params, state, batch)

    return in_mesh_order


def whole_tree(tree):
    """A copy of a tree of dicts, tuples and NamedTuples with every
    DTensor leaf gathered whole (partial.whole)."""
    from repro_torch.distributed.partial import whole
    if isinstance(tree, dict):
        return {k: whole_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [whole_tree(v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return whole(tree).detach().clone() if torch.is_tensor(tree) else tree


def run_steps(case, params, batches, mesh=None, *, zero3=False, zero1=False,
              data=1, model=1, order=True, early=frozenset()):
    """(losses, whole params, partial all-reduces per step, checks,
    kernel launches of the case's steps) of the case's train step on
    `mesh`, or with no mesh of one_device_step (with `data`, `model`,
    `zero3`, `order` and `early`).
    On a mesh, rank 0's `checks` holds for each step, all from the mesh
    step's own start (params, state and batch): the mesh step's params
    and loss, the one-device step's in the mesh's order (so that its
    gradient is the mesh's, bit for bit, where the order is exact:
    mesh_order), and the params the one-device optimizer makes of the
    mesh step's own gradient; on a mesh with a model axis also the
    gradients of the mesh step and of the one-device step; [] off a mesh
    and on the other ranks."""
    from repro_torch.core.optim.base import apply_updates, tree_items
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.partial import reduce_partials
    from repro_torch.distributed.steps import (build_train_step,
                                               place_train_step)
    tx, policy = make_tx(case["optimizer"])
    arch = case_arch(case["arch"], policy)
    seen, ref_seen = [], []
    step, init = build_train_step(
        loss_of(case["arch"], arch), recording(tx, seen), mesh, zero3=zero3,
        zero1=zero1, microbatches=case["microbatches"],
        param_init_fn=lambda _: params, policy=policy, heads=arch.heads,
        mamba=arch.mamba)
    p, o = init(None)
    ref = None
    if mesh is None:
        step = one_device_step(case, data, order=order, early=early,
                               model=model, zero3=zero3)
    else:
        pspec, ospec = step.specs_for(p, o)
        step = place_train_step(step, mesh, pspec, ospec, batches[0])
        shape = shd.mesh_shape(mesh)
        early = (early_paths(params, shape["data"], shape["model"])
                 if zero3 else frozenset())
        ref = one_device_step(case, shape["data"], early=early,
                              seen=ref_seen, model=shape["model"],
                              zero3=zero3)
    flat = lambda tree: dict(tree_items(whole_tree(tree)))
    losses, calls, checks = [], [], []
    launched = dict.fromkeys(launches(), 0)
    for b in batches:
        # every rank gathers (a collective); rank 0 alone runs the check
        start = (whole_tree(p), whole_tree(o)) if ref is not None else None
        before, counts = reduce_partials.calls, launches()
        p, o, m = step(p, o, b)
        losses.append(float(m["loss"]))
        calls.append(reduce_partials.calls - before)
        for k, n in launches().items():
            launched[k] += n - counts[k]
        if ref is not None:
            got = flat(p)
            if dist.get_rank() == 0:
                want, _, ref_m = ref(*start, b)
                upd, _ = tx.update(seen[-1], start[1], start[0])
                checks.append({
                    "params": got, "ref": flat(want),
                    "loss": losses[-1], "ref_loss": float(ref_m["loss"]),
                    "on_mesh_grads": dict(tree_items(
                        apply_updates(start[0], upd)))})
                if splits_matmuls(shape):
                    checks[-1].update(
                        grads=dict(tree_items(seen[-1])),
                        one_grads=dict(tree_items(ref_seen[-1])))
            seen.clear()
            ref_seen.clear()
    return losses, flat(p), calls, checks, launched


def launches():
    """{kernel: launches so far} of K1-K6 (counted on CUDA only)."""
    from repro_torch.kernels import lamb, lans
    return {k.__name__: k.launches for k in (*lans.KERNELS, *lamb.KERNELS)}


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree.to(device) if torch.is_tensor(tree) else tree


def run_rank(rank, world, store_path, layout, inputs_path, out_path,
             device="cpu"):
    torch.set_num_threads(1)
    backend = "gloo"
    if device == "cuda":
        from repro_torch import select_device
        select_device("cuda")           # TF32 off, as one device runs
        torch.cuda.set_device(rank)
        device, backend = f"cuda:{rank}", "nccl"
    dist.init_process_group(backend,
                            store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        from repro_torch.distributed import partial
        from repro_torch.launch.mesh import make_local_mesh
        mesh = make_local_mesh(data=layout["data"], model=layout["model"],
                               device=device.split(":")[0])
        inputs = to_device(torch.load(inputs_path), device)
        out = {}
        gathered = set()
        plain = partial.gather_leaf

        def recorded(t, cuts):
            # the shape of every leaf the fetch gathers, and the sizes of
            # the groups it gathers it over
            result = plain(t, cuts)
            if cuts:
                gathered.add((tuple(result.shape), tuple(
                    dist.get_world_size(g) for g, _, _ in cuts)))
            return result

        partial.gather_leaf = recorded
        for name, case in inputs["cases"].items():
            gathered.clear()
            losses, params, calls, checks, launched = run_steps(
                case, inputs["params"][case["arch"]], case["batches"], mesh,
                zero3=layout["zero3"], zero1=layout["zero1"])
            out[name] = {"losses": losses, "calls": calls,
                         "launches": launched, "gathered": sorted(gathered),
                         "params": (to_device(params, "cpu") if rank == 0
                                    else None),
                         "checks": (to_device(checks, "cpu") if rank == 0
                                    else None)}
        torch.save(out, f"{out_path}.{rank}")
    finally:
        dist.destroy_process_group()


def start_ranks(ctx, layout, tmp, inputs_path, tag, device="cpu"):
    """The processes of one layout's ranks (started), spawned from ctx."""
    world = layout["data"] * layout["model"]
    procs = [ctx.Process(target=run_rank, args=(
        r, world, str(tmp / f"store-{tag}"), layout, str(inputs_path),
        str(tmp / f"out-{tag}"), device)) for r in range(world)]
    for p in procs:
        p.start()
    return procs


def join_ranks(procs, tmp, tag, timeout):
    """Rank 0's results after every rank exited 0 within `timeout`
    (seconds, for each join), and every rank reported the same losses.
    A rank still alive is killed."""
    try:
        for p in procs:
            p.join(timeout)
        codes = [p.exitcode for p in procs]
        assert codes == [0] * len(procs), f"{tag}: rank exit codes {codes}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    ranks = [torch.load(tmp / f"out-{tag}.{r}") for r in range(len(procs))]
    for name in ranks[0]:
        assert all(r[name]["losses"] == ranks[0][name]["losses"]
                   for r in ranks), name
    return ranks[0]


def lm_batch(rng, cfg, rows=4):
    """A seeded batch of a decoder or whisper case: random tokens, their
    next tokens as labels (-100 at the end), and for whisper frames
    N(0, 1) from the same generator."""
    tok = rng.integers(0, cfg.vocab, size=(rows, SEQ)).astype(np.int32)
    lab = np.concatenate([tok[:, 1:], np.full((rows, 1), -100, np.int32)],
                         axis=1)
    b = {"tokens": tok, "labels": lab}
    if hasattr(cfg, "n_frames"):
        b["frames"] = rng.standard_normal(
            (rows, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return b


def port_inputs(seed=0):
    """Inputs made by the port alone (no JAX): params of the reduced arch
    of every case of ALL_CASES from a CPU torch.Generator, and seeded
    numpy batches (MLM with -100 on unmasked positions for BERT,
    lm_batch for the others)."""
    params, batches = {}, {}
    rng = np.random.default_rng(seed)
    for name in dict.fromkeys(a for a, _, _ in ALL_CASES.values()):
        arch = reduced(name)
        params[name] = arch.init(torch.Generator().manual_seed(seed))
        out = []
        for _ in range(STEPS):
            b = (_bert_batch(rng, arch.cfg) if name == "bert-large"
                 else lm_batch(rng, arch.cfg))
            out.append({k: torch.from_numpy(v) for k, v in b.items()})
        batches[name] = out
    cases = {name: dict(arch=a, optimizer=o, microbatches=mb,
                        batches=batches[a])
             for name, (a, o, mb) in ALL_CASES.items()}
    return params, cases


def key_bias(path):
    return path.endswith("wk/bias")


def assert_params_close(got, want, *, skip=()):
    """Every element of every leaf of `got` against `want` (path ->
    tensor), bar the paths in `skip`: fp32 within rtol 1e-5 and atol
    1e-6, bf16 within one bf16 ulp."""
    for path, a in want.items():
        b = got[path]
        assert a.dtype == b.dtype and a.shape == b.shape, path
        if path in skip:
            continue
        rtol = 2 ** -7 if a.dtype == torch.bfloat16 else 1e-5
        np.testing.assert_allclose(b.float().numpy(), a.float().numpy(),
                                   rtol=rtol, atol=1e-6, err_msg=path)


def assert_update_close(got, want):
    """Every element of every leaf: fp32 within 2e-5 (absolute), bf16
    within one bf16 ulp (as assert_params_close)."""
    for path, a in want.items():
        bf16 = a.dtype == torch.bfloat16
        np.testing.assert_allclose(got[path].float().numpy(),
                                   a.float().numpy(),
                                   rtol=2 ** -7 if bf16 else 0,
                                   atol=0 if bf16 else 2e-5, err_msg=path)


def check_step(check, layout):
    """One step of a mesh run (run_steps' checks), against the one-device
    step in the mesh's order from the same start: its params
    (assert_params_close). On a layout with a model axis also the
    gradient, every element of every leaf within rtol 1e-5 and atol 1e-6
    of the one-device gradient (bf16 compute: its fp32 gradients too),
    and the params the mesh makes of its own gradient against those the
    one-device optimizer makes of the same gradient
    (assert_update_close)."""
    if splits_matmuls(layout):
        for path, g in check["one_grads"].items():
            np.testing.assert_allclose(check["grads"][path].numpy(),
                                       g.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=f"gradient of {path}")
        assert_update_close(check["params"], check["on_mesh_grads"])
    assert_params_close(check["params"], check["ref"])


def check_against_one_device(got, want, layout, case):
    """A mesh run against the one-device step whose gradient is summed in
    the mesh's order (run_steps with the layout's data and model):
    - each step, from the mesh step's own params, state and batch
      (check_step);
    - the losses over the steps, fp32 within 1e-5 relative, under
      fused_mixed_lans (bf16) within 1e-4, as test_torch_train.py holds
      that transform against the generic wrapper;
    - the params after the steps, every element of every leaf, but for
      the attention key bias on a layout that cuts leaves over ranks.
    Params: fp32 within rtol 1e-5 and atol 1e-6, bf16 within one bf16
    ulp. The key bias's true gradient is 0 (it adds one constant to a
    query row's logits), so its gradient is rounding noise of all the
    params, which LANS's g / ||g|| scales to a unit-size step: once a
    cut leaf's norms, summed over the ranks in another order, have moved
    any param by its last bit, the next step's noise, and so the key
    bias's direction, is another. The per-step check holds it."""
    for check in got["checks"]:
        check_step(check, layout)
    bf16 = ALL_CASES[case][1] == "fused_mixed_lans"
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=1e-4 if bf16 else 1e-5)
    cuts = layout["model"] > 1 or layout["zero3"] or layout["zero1"]
    assert_params_close(got["params"], want["params"], skip={
        p for p in want["params"] if cuts and key_bias(p)})


CUT_ARCHS = ("bert-large", "qwen2.5-14b", "jamba-1.5-large-398b",
             "gemma2-2b")
# arch: {delta: the config fields changed from the reduced arch}. On 1 x
# 2 the FLOPs a delta adds or removes (a step's, counted on each rank)
# are half of one device's: "layers" a layer or a period (attention and
# MLP split on whole heads and ff columns), "vocab" the readout (and
# its cross entropy), "experts" the expert stacks' ff (on the dense
# route; jamba's dense MLP slots share d_ff and are split too), "mamba"
# the Mamba-2 mixers' d_inner (their heads: in_proj's z, x and dt
# columns, the SSD scan, out_proj). A jamba period is not a delta: its
# router and in_proj's B / C columns are whole on every rank.
FLOP_DELTAS = {
    "bert-large": {"layers": {"n_layers": 1}, "vocab": {"vocab": 1024}},
    "qwen2.5-14b": {"layers": {"n_layers": 1}, "vocab": {"vocab": 2048}},
    "jamba-1.5-large-398b": {"experts": {"d_ff": 512},
                             "mamba": {"mamba_d_inner": 1024},
                             "vocab": {"vocab": 2048}},
    "gemma2-2b": {"layers": {"n_layers": 4}, "vocab": {"vocab": 2048}},
}


def model_cut_shapes(arch):
    """(the shapes of the leaves of `arch` that a model axis computes on
    as their shards where the rules cut them: MoE expert stacks, the
    token embedding and lm_head, Mamba-2's in_proj, conv_w and out_proj;
    each as a whole and, stacked, a layer's; the same of every other
    leaf of two dims or more)."""
    from repro_torch.core.optim.base import tree_items
    with torch.device("meta"):
        params = arch.init(None)
    cut, other = set(), set()
    for path, v in tree_items(params):
        if v.ndim < 2:
            continue
        parts = path.split("/")
        named = (parts[-1] == "embedding" or path.endswith("lm_head/kernel")
                 or (parts[-1] in ("up", "gate", "down")
                     and parts[-2] == "ffn")
                 or path.endswith(("mixer/in_proj/kernel", "mixer/conv_w",
                                   "mixer/out_proj/kernel")))
        shapes = {tuple(v.shape)}
        if path.startswith(("layers", "slot", "enc_layers", "dec_layers")):
            shapes.add(tuple(v.shape[1:]))
        (cut if named else other).update(shapes)
    return cut, other


def _one_step(arch, mesh, zero3, batch, count_flops):
    """One fused_lans step of `arch` from a seeded init, on `mesh` or on
    one device; its matmul FLOPs on this rank when `count_flops`."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.core.optim import fused_lans
    from repro_torch.distributed.steps import (build_train_step,
                                               place_train_step)
    step, init = build_train_step(
        arch.loss_fn, fused_lans(LR), mesh, zero3=zero3,
        param_init_fn=arch.init, heads=arch.heads, mamba=arch.mamba)
    p, o = init(torch.Generator().manual_seed(0))
    if mesh is not None:
        pspec, ospec = step.specs_for(p, o)
        step = place_train_step(step, mesh, pspec, ospec, batch)
    counter = FlopCounterMode(display=False)
    with counter if count_flops else contextlib.nullcontext():
        step(p, o, batch)
    return counter.get_total_flops() if count_flops else None


def run_cut_rank(rank, world, store_path, layout, out_path):
    """One rank of test_torch_mesh_cut.py: for each of CUT_ARCHS, one step
    on the layout's mesh with every shape the fetch gathers recorded
    (partial.gather_leaf wrapped); with layout["flops"], also the matmul
    FLOPs of a step of the reduced arch and of each FLOP_DELTAS variant,
    on the mesh and (rank 0) on one device: {"base" or delta: (mesh,
    one or None)}."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        from repro_torch.distributed import partial
        from repro_torch.launch.mesh import make_local_mesh
        mesh = make_local_mesh(data=layout["data"], model=layout["model"],
                               device="cpu")
        seen = []
        plain = partial.gather_leaf

        def recorded(t, cuts):
            out = plain(t, cuts)
            if cuts:
                seen.append(tuple(out.shape))
            return out

        partial.gather_leaf = recorded
        out = {}
        rng = np.random.default_rng(0)
        for name in CUT_ARCHS:
            arch = case_arch(name, "fp32")
            batch = {k: torch.from_numpy(v) for k, v in (
                lm_batch(rng, arch.cfg).items() if name != "bert-large"
                else _bert_batch(rng, arch.cfg).items())}
            seen.clear()
            _one_step(arch, mesh, layout["zero3"], batch, False)
            res = {"gathered": list(seen)}
            if layout.get("flops"):
                res["flops"] = {}
                variants = {"base": {}, **FLOP_DELTAS[name]}
                for delta, over in variants.items():
                    a = dataclasses.replace(arch, cfg=dataclasses.replace(
                        arch.cfg, **over))
                    res["flops"][delta] = (
                        _one_step(a, mesh, layout["zero3"], batch, True),
                        _one_step(a, None, False, batch, True) if rank == 0
                        else None)
            out[name] = res
        torch.save(out, f"{out_path}.{rank}")
    finally:
        dist.destroy_process_group()


def _bert_batch(rng, cfg, rows=4):
    tok = rng.integers(0, cfg.vocab, size=(rows, SEQ))
    lab = np.where(rng.random((rows, SEQ)) < 0.15, tok, -100)
    b = {"tokens": tok, "mlm_labels": lab,
         "nsp_labels": rng.integers(0, 2, size=(rows,)),
         "token_types": np.zeros_like(tok)}
    return {k: v.astype(np.int32) for k, v in b.items()}


def memory_step(mesh=None, *, zero3=False, device="cuda", steps=2):
    """Peak card memory (bytes) over `steps` fused_lans steps of
    BERT-large at full width (fp32, seq 128, global batch 16, seed 0) on
    `mesh`, or on one device; the params placed (cut) before the peak is
    reset, so that it is the step's."""
    import gc
    from repro_torch.configs import get_arch
    from repro_torch.core.optim import fused_lans
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.steps import (build_train_step,
                                               place_train_step)
    from repro_torch.launch import train as train_mod
    arch = get_arch("bert-large")
    arch = dataclasses.replace(arch, cfg=dataclasses.replace(
        arch.cfg, compute_dtype=torch.float32))
    data = train_mod.make_data(arch, batch=16, seq=128, seed=0)
    batches = [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
               for b, _ in zip(data, range(steps))]
    step, init = build_train_step(
        arch.loss_fn, fused_lans(LR), mesh, zero3=zero3,
        param_init_fn=arch.init, heads=arch.heads)
    p, o = init(torch.Generator(device=device).manual_seed(0))
    if mesh is not None:
        pspec, ospec = step.specs_for(p, o)
        p, o = shd.distribute(p, mesh, pspec), shd.distribute(o, mesh, ospec)
        step = place_train_step(step, mesh, pspec, ospec, batches[0])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for b in batches:
        p, o, _ = step(p, o, b)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def run_memory_rank(rank, world, store_path, layout, out_path):
    """One rank (card `rank`, NCCL) of the full-width memory run on four
    cards: memory_step on the layout's mesh; writes the peak."""
    from repro_torch import select_device
    select_device("cuda")
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        from repro_torch.launch.mesh import make_local_mesh
        mesh = make_local_mesh(data=layout["data"], model=layout["model"],
                               device="cuda")
        peak = memory_step(mesh, zero3=layout["zero3"],
                           device=f"cuda:{rank}")
        torch.save({"peak": peak}, f"{out_path}.{rank}")
    finally:
        dist.destroy_process_group()


# the dry run against real runs (test_torch_dryrun.py): name -> (arch,
# microbatches); the unfused lans of the JAX dry run's optimizer
COUNT_CASES = {"bert": ("bert-large", 2),
               "granite": ("granite-moe-3b-a800m", 1),
               "gemma2": ("gemma2-2b", 1)}


def count_batch(name, rows=4):
    """The seeded batch of a COUNT_CASES case (its shapes are what the dry
    run sees)."""
    arch = case_arch(COUNT_CASES[name][0], "fp32")
    rng = np.random.default_rng(0)
    b = (_bert_batch(rng, arch.cfg, rows) if arch.kind == "bert"
         else lm_batch(rng, arch.cfg, rows))
    return {k: torch.from_numpy(v) for k, v in b.items()}


def count_case(name, mesh, layout, gen=None):
    """The dry run's record (launch/dryrun.py: trace_train) of one step of
    a COUNT_CASES case on `mesh` with the layout's zero3 / zero1: on meta
    tensors, or with a torch.Generator `gen` on real ones."""
    from repro_torch.core.optim import lans
    from repro_torch.launch import dryrun
    arch_name, mb = COUNT_CASES[name]
    arch = dataclasses.replace(case_arch(arch_name, "fp32"),
                               zero3=layout["zero3"], zero1=layout["zero1"])
    analysis, _ = dryrun.trace_train(arch, count_batch(name), mesh,
                                     microbatches=mb, tx=lans(LR), gen=gen)
    keep = ("flops_by_dtype", "bytes_accessed", "collective_bytes",
            "collective_counts", "memory_analysis")
    return {k: analysis[k] for k in keep}


def run_count_rank(rank, world, store_path, layout, out_path):
    """One gloo rank of the dry run's check: every COUNT_CASES step run on
    real CPU tensors on the layout's mesh, counted by the dry run's
    tracer; writes {case: record}."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        from repro_torch.launch.mesh import make_local_mesh
        mesh = make_local_mesh(data=layout["data"], model=layout["model"],
                               device="cpu")
        out = {name: count_case(name, mesh, layout,
                                gen=torch.Generator().manual_seed(0))
               for name in COUNT_CASES}
        torch.save(out, f"{out_path}.{rank}")
    finally:
        dist.destroy_process_group()


def dry_counts(layouts):
    """{layout: [each rank's {case: record}]} of the dry run on meta
    tensors, each rank in a fake process group of the layout's ranks (run
    in a process of its own: the dry run takes the default group)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    out = {}
    for lname, layout in layouts.items():
        world = layout["data"] * layout["model"]
        out[lname] = []
        for rank in range(world):
            with dryrun.fake_world(world, rank):
                mesh = make_local_mesh(data=layout["data"],
                                       model=layout["model"], device="cpu")
                out[lname].append({name: count_case(name, mesh, layout)
                                   for name in COUNT_CASES})
    return out
