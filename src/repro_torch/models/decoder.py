"""Decoder-only LM (port of repro/models/decoder.py), attention + MLP slots.

The layer stack is a repeating SUPERBLOCK of (mixer, ffn) slots, e.g.
gemma2's (("attn_local", "mlp"), ("attn", "mlp")) x 13 periods. As in the
JAX package, each slot's params are stacked over the periods
(`params["slot{i}"]` leaves have a leading n_periods dim) and so are its
caches; where JAX scans over periods, the port runs a Python loop and
hands each layer the period's view `stacked[p]` — a contiguous slice, so
the paged kernel writes the arena in place.

Ported: "attn" / "attn_local" mixers with "mlp" ffns and tied
embeddings (the readout is x @ E^T). MoE and Mamba slots, QK-norm, an
untied head, remat and the losses are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models.attention import AttnConfig, attn_apply, attn_init
from repro_torch.models.common import (embed_apply, embed_attend,
                                       embed_init, mlp_apply, mlp_init,
                                       rmsnorm_apply, rmsnorm_init, softcap)


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None

    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None       # window of "attn_local" slots
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    post_block_norm: bool = False
    attn_kernel: str = "xla"                   # paged decode: "xla" | "paged"

    activation: str = "silu"
    gated_mlp: bool = True

    superblock: Tuple[Tuple[str, str], ...] = (("attn", "mlp"),)

    scale_embeds: bool = False
    compute_dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_periods(self) -> int:
        if self.n_layers % len(self.superblock):
            raise ValueError(f"{self.n_layers} layers do not divide into "
                             f"superblocks of {len(self.superblock)}")
        return self.n_layers // len(self.superblock)

    def attn_cfg(self, local: bool) -> AttnConfig:
        return AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.resolved_head_dim,
            qkv_bias=self.qkv_bias, rope_theta=self.rope_theta,
            sliding_window=self.sliding_window if local else None,
            logit_softcap=self.attn_softcap,
            decode_kernel=self.attn_kernel)


def _check_slot(mixer: str, ffn: str):
    if mixer not in ("attn", "attn_local") or ffn != "mlp":
        raise NotImplementedError(
            f"slot ({mixer}, {ffn}) is not ported yet: the port has "
            f"attention + MLP slots only")


def _slot_init(gen, cfg: DecoderConfig, mixer: str, ffn: str):
    _check_slot(mixer, ffn)
    lead = (cfg.n_periods,)
    dev, dt = (None if gen is None else gen.device), cfg.param_dtype
    p = {"pre_mixer_norm": rmsnorm_init(cfg.d_model, dt, dev, lead),
         "pre_ffn_norm": rmsnorm_init(cfg.d_model, dt, dev, lead)}
    if cfg.post_block_norm:
        p["post_mixer_norm"] = rmsnorm_init(cfg.d_model, dt, dev, lead)
        p["post_ffn_norm"] = rmsnorm_init(cfg.d_model, dt, dev, lead)
    p["mixer"] = attn_init(gen, cfg.attn_cfg(mixer == "attn_local"),
                           dtype=dt, lead=lead)
    p["ffn"] = mlp_init(gen, cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp,
                        dtype=dt, lead=lead)
    return p


def decoder_init(gen: torch.Generator, cfg: DecoderConfig):
    """Random params on `gen.device`, drawn from `gen`. Slot params are
    stacked over the periods. gen=None draws on the ambient default
    device (under `torch.device("meta")`: shapes only)."""
    params = {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, cfg.param_dtype),
        "final_norm": rmsnorm_init(cfg.d_model, cfg.param_dtype,
                                   None if gen is None else gen.device),
    }
    for si, (mixer, ffn) in enumerate(cfg.superblock):
        params[f"slot{si}"] = _slot_init(gen, cfg, mixer, ffn)
    return params


def _period(tree, p: int):
    """Period p of a stacked param subtree (views, no copies)."""
    return {k: _period(v, p) if isinstance(v, dict) else v[p]
            for k, v in tree.items()}


def _run_slot(sp, cfg: DecoderConfig, mixer: str, x, positions, cache):
    h = rmsnorm_apply(sp["pre_mixer_norm"], x)
    out, _ = attn_apply(sp["mixer"], cfg.attn_cfg(mixer == "attn_local"), h,
                        positions=positions, cache=cache,
                        compute_dtype=cfg.compute_dtype)
    if cfg.post_block_norm:
        out = rmsnorm_apply(sp["post_mixer_norm"], out)
    x = x + out
    h = rmsnorm_apply(sp["pre_ffn_norm"], x)
    out = mlp_apply(sp["ffn"], h, activation=cfg.activation,
                    compute_dtype=cfg.compute_dtype)
    if cfg.post_block_norm:
        out = rmsnorm_apply(sp["post_ffn_norm"], out)
    return x + out


def decoder_apply(params, cfg: DecoderConfig, tokens, *, positions=None,
                  caches=None):
    """Forward pass -> (logits fp32 (B, S, vocab), new_caches).

    tokens (B, S) int. caches: from init_decoder_cache (per-slot dense)
    or init_paged_decoder_cache; they are written in place and returned
    with the advanced index (None without caches)."""
    x = embed_apply(params["embed"], tokens, cfg.compute_dtype)
    if cfg.scale_embeds:
        x = x * torch.sqrt(torch.tensor(float(cfg.d_model))).to(
            cfg.compute_dtype)
    B, S = x.shape[:2]
    if positions is None:
        ar = torch.arange(S, device=x.device)
        positions = (caches["index"][:, None] + ar if caches is not None
                     else ar)
    tables = caches.get("tables") if caches is not None else None

    for p in range(cfg.n_periods):
        for si, (mixer, ffn) in enumerate(cfg.superblock):
            _check_slot(mixer, ffn)
            cache_i = None
            if caches is not None:
                stack = caches["slots"][si]
                cache_i = {k: stack[k][p] for k in ("k", "v", "pos")}
                cache_i["index"] = caches["index"]
                if tables is not None:
                    cache_i["table"] = tables[si]
            x = _run_slot(_period(params[f"slot{si}"], p), cfg, mixer, x,
                          positions, cache_i)

    new_caches = None
    if caches is not None:
        new_caches = {"slots": caches["slots"],
                      "index": caches["index"] + S}
        if tables is not None:
            new_caches["tables"] = tables
    x = rmsnorm_apply(params["final_norm"], x)
    return _head_logits(params, cfg, x), new_caches


def _head_logits(params, cfg: DecoderConfig, x):
    logits = embed_attend(params["embed"], x, cfg.compute_dtype)
    return softcap(logits.float(), cfg.final_softcap)


def init_decoder_cache(cfg: DecoderConfig, batch: int, max_len: int,
                       dtype=torch.bfloat16, *, device="cpu"):
    """Pooled per-slot caches stacked per superblock slot; "attn_local"
    slots get ring buffers of the window size. KV is stored in `dtype`
    (bf16 by default, as in the JAX package, whatever the compute
    precision)."""
    slots = []
    for mixer, ffn in cfg.superblock:
        _check_slot(mixer, ffn)
        L = max_len
        if mixer == "attn_local" and cfg.sliding_window:
            L = min(max_len, cfg.sliding_window)
        slots.append(attn_lib.init_kv_cache(
            batch, L, cfg.n_kv_heads, cfg.resolved_head_dim, dtype,
            device, lead=(cfg.n_periods,)))
    return {"slots": tuple(slots),
            "index": torch.zeros((batch,), dtype=torch.int32, device=device)}


def paged_layout(cfg: DecoderConfig, max_len: int, block_size: int,
                 row_margin: int = 0):
    """Per-superblock-slot paged layout: [(slot_idx, ring_len)]. The ring
    is max_len rows, or the sliding window for "attn_local" slots.

    row_margin > 0 widens every ring by that many rows, rounded up to
    whole blocks: the speculative verify step writes its K rows before
    attention reads, so a ring needs K - 1 rows beyond what any live
    query still attends to (window + K - 1 for sliding-window rings;
    max_len + K - 1 for full rings, which a budget-truncated final round
    still writes up to cursor + K - 1)."""
    margin = -(-row_margin // block_size) * block_size if row_margin else 0
    out = []
    for si, (mixer, ffn) in enumerate(cfg.superblock):
        _check_slot(mixer, ffn)
        L = max_len
        if mixer == "attn_local" and cfg.sliding_window:
            L = min(max_len, cfg.sliding_window)
        L += margin
        if L % block_size != 0:
            raise ValueError(
                f"slot {si} ({mixer}): cache length {L} not a multiple of "
                f"block_size {block_size}")
        out.append((si, L))
    return out


def init_paged_decoder_cache(cfg: DecoderConfig, batch: int, max_len: int,
                             *, block_size: int, n_blocks,
                             dtype=torch.bfloat16, device="cpu",
                             row_margin: int = 0):
    """Paged cache: per attention slot-type a (n_periods, n_blocks + 1,
    block_size, ...) arena (block 0 the null block) and a (batch,
    ring_len // block_size) int32 table of zeros; per-slot LOCAL write
    cursors under "index". n_blocks: data blocks per arena, an int or
    {slot_idx: int}. row_margin widens the rings (paged_layout)."""
    slots, tables = [], []
    for si, ring_len in paged_layout(cfg, max_len, block_size, row_margin):
        nb = n_blocks[si] if isinstance(n_blocks, dict) else n_blocks
        slots.append(attn_lib.init_paged_kv_cache(
            nb + 1, block_size, cfg.n_kv_heads, cfg.resolved_head_dim,
            dtype, device, lead=(cfg.n_periods,)))
        tables.append(torch.zeros((batch, ring_len // block_size),
                                  dtype=torch.int32, device=device))
    return {"slots": tuple(slots), "tables": tuple(tables),
            "index": torch.zeros((batch,), dtype=torch.int32, device=device)}
