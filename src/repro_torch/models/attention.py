"""Grouped-query attention (port of repro/models/attention.py).

Variants ported: GQA / MHA / MQA, causal with RoPE (the decoders) or
bidirectional without a positional op (BERT), optional QKV bias, QK-norm
(RMSNorm over head_dim of q and k, before RoPE; chameleon) and query
scale, attention-logit soft-capping and sliding-window masking; the
full-sequence path (cache-free; sequences of `q_chunk_threshold` or
more that divide into `q_block`s attend one query block at a time, each
recomputed in the backward pass, as the JAX package's remat-chunked
branch), the pooled per-slot cache (prefill into a dense cache,
including the ring-tail write of sliding-window layers) and the paged
serving branch with both decode implementations:

  decode_kernel="paged"  the hand-written kernel
                         (kernels/paged_attention.py) attends and writes
                         the new K/V/pos rows in one call;
  decode_kernel="xla"    plain-torch scatter then block-table gather —
                         the name matches the JAX flag it mirrors.

With `kernel_interpret` the "paged" branch calls the kernel's plain
PyTorch version (paged_attention_fused_plain) on any device: JAX's
Pallas interpret mode, the escape hatch for a layout the kernel cannot
take; it launches nothing.

Caches are updated IN PLACE where the JAX code returned updated copies
of donated buffers: the returned cache dict holds the same arena
tensors, already written. The single-stream cache (a scalar write
cursor and one position row shared by the batch; the encoder-decoder's
`decode`) is written in place too.

Cross-attention (the whisper decoder): `kv_x=` projects K and V from the
encoder memory (training), `kv_cache=` attends K/V precomputed once at
admission, read-only (serving), either dense {"k","v"[,"pos"]} or
gathered from the paged cross arena {"k","v","pos","table"}. Cross is
never causal, never rotated, and keeps compute-dtype probabilities at
any S (the fp32 "decode" rule is the self-attention cache's).

Shapes: x (B, S, d_model); dense cache k/v (B, L, n_kv, head_dim);
paged arenas (n_blocks, block_size, n_kv, head_dim).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import NEG_INF
from repro_torch.metrics.spans import span
from repro_torch.models.common import (apply_rope, dense_apply, dense_init,
                                       rmsnorm_apply, rmsnorm_init, softcap,
                                       tp_enter)


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    rope: bool = True
    rope_theta: float = 10000.0
    causal: bool = True
    sliding_window: Optional[int] = None
    logit_softcap: Optional[float] = None
    query_scale: Optional[float] = None  # default 1/sqrt(head_dim)
    # Sequences >= q_chunk_threshold (and divisible by q_block) attend in
    # query blocks of q_block rows, each recomputed in the backward pass:
    # the live logits are (B, H, q_block, S), not (B, H, S, S).
    q_chunk_threshold: int = 4096
    q_block: int = 1024
    # Paged decode implementation: "xla" scatters then gathers
    # arena[table] into a dense (B, ring_len) copy; "paged" runs the
    # fused kernel. Only the paged serving branch reads this.
    decode_kernel: str = "xla"
    # decode_kernel "paged" through the kernel's plain PyTorch version on
    # any device (the JAX package's Pallas interpret mode): the hatch for
    # a layout the kernel cannot take
    kernel_interpret: bool = False


def attn_init(gen: torch.Generator, cfg: AttnConfig, *, cross: bool = False,
              dtype=torch.float32, lead: tuple = ()):
    """`cross` changes nothing (the JAX signature's flag): a
    cross-attention block has the same four projections."""
    del cross
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(dtype=dtype, lead=lead)
    p = {
        "wq": dense_init(gen, d, h * hd, use_bias=cfg.qkv_bias, **kw),
        "wk": dense_init(gen, d, kv * hd, use_bias=cfg.qkv_bias, **kw),
        "wv": dense_init(gen, d, kv * hd, use_bias=cfg.qkv_bias, **kw),
        "wo": dense_init(gen, h * hd, d, use_bias=False, **kw),
    }
    if cfg.qk_norm:
        dev = None if gen is None else gen.device
        p["q_norm"] = rmsnorm_init(hd, dtype, dev, lead)
        p["k_norm"] = rmsnorm_init(hd, dtype, dev, lead)
    return p


def _split_heads(x, n, hd):
    return x.reshape(*x.shape[:-1], n, hd)


def _mask_logits(logits, q_pos, k_pos, *, causal, window):
    """logits (B, H, Sq, Sk); q_pos (Sq,) or (B, Sq), k_pos (Sk,) or
    (B, Sk) absolute positions. Negative k_pos marks invalid rows and is
    always masked."""
    kp = k_pos[None, None, :] if k_pos.ndim == 1 else k_pos[:, None, :]
    qp = q_pos[None, :, None] if q_pos.ndim == 1 else q_pos[:, :, None]
    ok = kp >= 0
    if causal:
        ok = ok & (kp <= qp)
    if window is not None:
        ok = ok & ((qp - kp) < window)
    ok = ok.expand((ok.shape[0],) + tuple(logits.shape[-2:]))
    return torch.where(ok[:, None], logits, NEG_INF)


def _attend(cfg: AttnConfig, q, k, v, q_pos, k_pos, *, scale, decode,
            causal, compute_dtype):
    """Masked softmax attention. Decode (a cached single-token step, or
    any paged step) contracts in fp32 and keeps fp32 probabilities; the
    output still rounds to compute_dtype, as in the JAX package."""
    if decode:
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    else:
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    logits = softcap(logits, cfg.logit_softcap)
    logits = _mask_logits(logits.float(), q_pos, k_pos, causal=causal,
                          window=cfg.sliding_window)
    probs = torch.softmax(logits, dim=-1)
    if decode:
        return torch.einsum("bhqk,bkhd->bqhd", probs,
                            v.float()).to(compute_dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(compute_dtype), v)


def attn_apply(p, cfg: AttnConfig, x, *, kv_x=None, positions=None,
               cache=None, kv_cache=None, compute_dtype=torch.bfloat16):
    """Returns (out, new_cache); new_cache is None unless cache is given.

    cache forms: a pooled dense cache {"k", "v" (B, L, n_kv, hd), "pos"
    (B, L), "index" (B,)}; a single-stream one, the same with "pos" (L,)
    and a 0-d "index"; or a paged one {"k", "v" (n_blocks, bs, n_kv,
    hd), "pos" (n_blocks, bs), "index" (B,), "table" (B, max_blocks)}.
    All are written in place.

    kv_x (B, Sm, d_model): cross-attention memory, K/V projected from it
    at key positions 0..Sm-1. kv_cache: read-only cross K/V, dense
    {"k", "v" (B, Sm, n_kv, hd)[, "pos" (Sm,) or (B, Sm)]} or paged
    {"k", "v" (n_blocks, bs, n_kv, hd), "pos" (n_blocks, bs), "table"
    (B, max_blocks)}, gathered through the table; pad rows carry
    position -1 and are masked. kv_cache excludes cache and kv_x.

    In a train step on a mesh whose fetch hands over column-parallel
    wq / wk / wv (models/common.py), the block runs on this rank's
    heads: h and n_kv are read off the kernels' columns, QK-norm, GQA,
    the masks and the query blocks work on them unchanged, and the
    row-parallel wo sums the ranks' outputs."""
    with span("model.attention"):
        return _attn_apply(p, cfg, x, kv_x=kv_x, positions=positions,
                           cache=cache, kv_cache=kv_cache,
                           compute_dtype=compute_dtype)


def _attn_apply(p, cfg: AttnConfig, x, *, kv_x, positions, cache, kv_cache,
                compute_dtype):
    B, S, _ = x.shape
    hd = cfg.head_dim
    wq = p["wq"]["kernel"]
    h, kv = wq.shape[-1] // hd, p["wk"]["kernel"].shape[-1] // hd
    scale = (cfg.query_scale if cfg.query_scale is not None
             else 1.0 / math.sqrt(hd))

    q = _split_heads(dense_apply(p["wq"], x, compute_dtype), h, hd)
    if kv_cache is None:
        src = x if kv_x is None else kv_x
        k = _split_heads(dense_apply(p["wk"], src, compute_dtype), kv, hd)
        v = _split_heads(dense_apply(p["wv"], src, compute_dtype), kv, hd)
    if cfg.qk_norm:
        # every branch below, the paged kernel's included, sees the
        # normed q and k; on local heads each norm's gradient is a part
        # of its sum over all heads
        qn, kn = p["q_norm"], p["k_norm"]
        q = rmsnorm_apply({"scale": tp_enter(qn["scale"], wq)}, q)
        if kv_cache is None:
            k = rmsnorm_apply({"scale": tp_enter(kn["scale"], wq)}, k)

    if positions is None:
        positions = torch.arange(S, device=x.device)
    if positions.ndim <= 1:
        positions = positions.expand(S)
    if cfg.rope and kv_x is None and kv_cache is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    attend_cached = cache is not None
    paged = cache is not None and "table" in cache
    if kv_cache is not None:
        if cache is not None or kv_x is not None:
            raise ValueError("kv_cache is exclusive with cache/kv_x")
        if "table" in kv_cache:
            # the paged cross arena: the block-table gather of the paged
            # self-attention read path
            tl = kv_cache["table"].long()
            mem_len = tl.shape[1] * kv_cache["k"].shape[1]
            k = kv_cache["k"][tl].reshape(B, mem_len, kv, hd)
            v = kv_cache["v"][tl].reshape(B, mem_len, kv, hd)
            k_pos = kv_cache["pos"][tl].reshape(B, mem_len)
        else:
            k, v = kv_cache["k"], kv_cache["v"]
            k_pos = kv_cache.get("pos")
            if k_pos is None:
                k_pos = torch.arange(k.shape[1], device=x.device)
        k = k.to(compute_dtype)
        v = v.to(compute_dtype)
        q_pos = positions
    elif paged:
        # Paged decode: cache k/v/pos are block ARENAS; logical row r of
        # slot b lives at arena[table[b, r // bs], r % bs] with r taken
        # modulo the ring, which gives sliding-window layers their ring.
        idx = cache["index"]
        tbl = cache["table"]
        bsz = cache["k"].shape[1]
        ring_len = tbl.shape[1] * bsz
        k_new = k.to(cache["k"].dtype).contiguous()
        v_new = v.to(cache["v"].dtype).contiguous()
        q_pos = (positions if positions.ndim == 2
                 else positions.expand(B, S)).to(torch.int32).contiguous()
        if cfg.decode_kernel == "paged":
            from repro_torch.kernels import paged_attention as pa
            fused = (pa.paged_attention_fused_plain if cfg.kernel_interpret
                     else pa.paged_attention_fused)
            out = fused(
                q.contiguous(), k_new, v_new, cache["k"], cache["v"],
                cache["pos"], tbl, q_pos, idx, scale=scale,
                window=cfg.sliding_window, softcap=cfg.logit_softcap)
            new_cache = {"k": cache["k"], "v": cache["v"],
                         "pos": cache["pos"], "index": idx + S}
            out = out.to(compute_dtype).reshape(B, S, h * hd)
            return dense_apply(p["wo"], out, compute_dtype), new_cache
        if cfg.decode_kernel != "xla":
            raise ValueError(f"unknown decode_kernel {cfg.decode_kernel!r}")
        r = (idx.long()[:, None]
             + torch.arange(S, device=x.device)) % ring_len
        blk = torch.gather(tbl.long(), 1, r // bsz)
        off = r % bsz
        # rows with a negative position go to the null block's row 0,
        # which keeps position -1 (as the JAX XLA branch does)
        live = q_pos >= 0
        blk = torch.where(live, blk, 0)
        off = torch.where(live, off, 0)
        cache["k"][blk, off] = k_new
        cache["v"][blk, off] = v_new
        cache["pos"][blk, off] = q_pos
        new_cache = {"k": cache["k"], "v": cache["v"], "pos": cache["pos"],
                     "index": idx + S}
        tl = tbl.long()
        k = cache["k"][tl].reshape(B, ring_len, kv, hd).to(compute_dtype)
        v = cache["v"][tl].reshape(B, ring_len, kv, hd).to(compute_dtype)
        k_pos = cache["pos"][tl].reshape(B, ring_len)
    elif cache is not None and S > 1 and S >= cache["k"].shape[1]:
        # Prefill longer than a ring cache (sliding-window layer), or as
        # long as the cache: attend the in-flight k/v and write only the
        # LAST cache_len rows, rolled so that row == write cursor %
        # cache_len. Assumes a prefill from scratch (index 0), the only
        # way the engine uses it.
        attend_cached = False
        W = cache["k"].shape[1]
        shift = (S - W) % W
        pos_src = (positions if positions.ndim == 2
                   else positions.expand(B, S)).to(torch.int32)
        pos_tail = torch.roll(pos_src[:, S - W:], shift, dims=1)
        cache["k"].copy_(torch.roll(k[:, S - W:], shift, dims=1))
        cache["v"].copy_(torch.roll(v[:, S - W:], shift, dims=1))
        # a single-stream cache keeps one position row for the batch
        cache["pos"].copy_(pos_tail if cache["pos"].ndim == 2
                           else pos_tail[0])
        new_cache = {"k": cache["k"], "v": cache["v"], "pos": cache["pos"],
                     "index": cache["index"] + S}
        k_pos = positions
        q_pos = positions
    elif cache is not None and cache["index"].ndim == 0:
        # Single-stream cache: the batch shares one write cursor and one
        # position row. The S rows land at cursor % cache_len, the start
        # clamped so that they fit (the JAX dynamic_update_slice); rows
        # at or past the cursor + S are not valid keys yet.
        idx = cache["index"]
        cache_len = cache["k"].shape[1]
        start = min(int(idx) % cache_len, cache_len - S)
        q_pos = idx + torch.arange(S, device=x.device)
        cache["k"][:, start:start + S] = k.to(cache["k"].dtype)
        cache["v"][:, start:start + S] = v.to(cache["v"].dtype)
        cache["pos"][start:start + S] = q_pos.to(torch.int32)
        new_cache = {"k": cache["k"], "v": cache["v"], "pos": cache["pos"],
                     "index": idx + S}
        k = cache["k"].to(compute_dtype)
        v = cache["v"].to(compute_dtype)
        k_pos = torch.where(cache["pos"] < idx + S, cache["pos"], -1)
    elif cache is not None:
        # Prefill / decode into a pooled dense cache: slot b writes rows
        # index[b] .. index[b]+S-1 (mod cache_len).
        idx = cache["index"]
        cache_len = cache["k"].shape[1]
        rows = (idx.long()[:, None]
                + torch.arange(S, device=x.device)) % cache_len
        brow = torch.arange(B, device=x.device)[:, None]
        q_pos = (positions if positions.ndim == 2
                 else positions.expand(B, S)).to(torch.int32)
        cache["k"][brow, rows] = k.to(cache["k"].dtype)
        cache["v"][brow, rows] = v.to(cache["v"].dtype)
        cache["pos"][brow, rows] = q_pos
        new_cache = {"k": cache["k"], "v": cache["v"], "pos": cache["pos"],
                     "index": idx + S}
        k = cache["k"].to(compute_dtype)
        v = cache["v"].to(compute_dtype)
        k_pos = cache["pos"]
    else:
        k_pos = (torch.arange(k.shape[1], device=x.device)
                 if kv_x is not None else positions)
        q_pos = positions

    if kv != h:
        k = k.repeat_interleave(h // kv, dim=2)
        v = v.repeat_interleave(h // kv, dim=2)
    # a chunk of a chunked prefill (S >= 2 rows on the dense cache) keeps
    # decode False, the prefill's numerics: hence chunks of >= 2 rows
    # (serving/admission.chunk_granularity)
    decode = attend_cached and (S == 1 or paged)
    causal = cfg.causal and kv_x is None and kv_cache is None
    kw = dict(scale=scale, decode=decode, causal=causal,
              compute_dtype=compute_dtype)
    qb = cfg.q_block
    if not attend_cached and S >= cfg.q_chunk_threshold and S % qb == 0:
        # remat-chunked query blocks: the live logits are (B, H, qb, S),
        # and the backward pass recomputes each block's probabilities
        # instead of keeping them
        outs = []
        for i in range(0, S, qb):
            qp = q_pos[..., i:i + qb]     # (qb,) or per-batch (B, qb)
            if torch.is_grad_enabled():
                o = checkpoint(_attend, cfg, q[:, i:i + qb], k, v, qp, k_pos,
                               use_reentrant=False, **kw)
            else:
                o = _attend(cfg, q[:, i:i + qb], k, v, qp, k_pos, **kw)
            outs.append(o)
        out = torch.cat(outs, dim=1)
    else:
        out = _attend(cfg, q, k, v, q_pos, k_pos, **kw)
    out = out.reshape(B, S, h * hd)
    return dense_apply(p["wo"], out, compute_dtype), new_cache


def init_paged_kv_cache(n_blocks: int, block_size: int, n_kv: int,
                        head_dim: int, dtype=torch.bfloat16, device="cpu",
                        lead: tuple = ()):
    """Block arena for one attention slot-type. Block 0 is the reserved
    null block: its positions stay -1, so unbacked table entries read
    rows that are always masked."""
    shape = (*lead, n_blocks, block_size, n_kv, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((*lead, n_blocks, block_size), -1,
                          dtype=torch.int32, device=device),
    }


def init_kv_cache(batch: int, max_len: int, n_kv: int, head_dim: int,
                  dtype=torch.bfloat16, device="cpu", lead: tuple = ()):
    """Pooled (per-slot) cache: one position row per batch slot; pass
    max_len = sliding_window for ring-buffer layers."""
    return {
        "k": torch.zeros((*lead, batch, max_len, n_kv, head_dim),
                         dtype=dtype, device=device),
        "v": torch.zeros((*lead, batch, max_len, n_kv, head_dim),
                         dtype=dtype, device=device),
        "pos": torch.full((*lead, batch, max_len), -1, dtype=torch.int32,
                          device=device),
    }
