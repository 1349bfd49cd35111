"""Encoder-decoder transformer, the whisper-large-v3 backbone (port of
repro/models/encdec.py).

Whisper conventions: pre-LN LayerNorm, GELU MLP with biases (not
gated), learned positions (no RoPE), MHA (n_kv == n_heads), QKV bias.
The mel-spectrogram and conv frontend is a stub: the model takes
precomputed frame embeddings (B, n_frames, d_model).

As in models/bert.py, each stack's layer params are stacked on a leading
n_layers axis, and every layer is recomputed in the backward pass
(torch.utils.checkpoint where the JAX package remats its scanned layer):
the encoder's always, the decoder's on the training path (no cache).
Nothing is recomputed where autograd records nothing. On a mesh a
layer's leaves are fetched inside its recomputed region
(models/common.py: layer_params), the others at their use, the tied
decoder embedding once for the lookup and the readout.

Serving (`prefill_serve`, `decode_serve`): the encoder runs once per
request at admission, the cross-attention K/V are projected once
(`precompute_cross_kv`) and every decode step reads them through
attention's read-only `kv_cache` form, dense or from the paged cross
arena of serving/cache_pool.EncDecCachePool; the self-attention KV is a
pooled per-slot cache, written in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import (AttnConfig, attn_apply, attn_init,
                                          init_kv_cache)
from repro_torch.models.common import (_randn, dense_apply, embed_apply,
                                       embed_attend, embed_init, fetch,
                                       fetch_tree, keep_vocab, layer_params,
                                       layernorm_apply, layernorm_init,
                                       mlp_apply, mlp_init, unbind_layers)


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    name: str
    n_layers: int           # per stack (encoder and decoder each)
    d_model: int
    n_heads: int
    d_ff: int
    vocab: int
    n_frames: int = 1500    # whisper encoder positions
    max_target: int = 448
    compute_dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def attn_cfg(self, causal: bool) -> AttnConfig:
        return AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_heads, head_dim=self.head_dim,
            qkv_bias=True, rope=False, causal=causal)


def _mlp_init(gen, cfg: EncDecConfig, lead):
    return mlp_init(gen, cfg.d_model, cfg.d_ff, gated=False, use_bias=True,
                    dtype=cfg.param_dtype, lead=lead)


def _ln_init(gen, cfg: EncDecConfig, lead=()):
    return layernorm_init(cfg.d_model, cfg.param_dtype,
                          None if gen is None else gen.device, lead)


def _enc_layer_init(gen, cfg: EncDecConfig, lead=()):
    return {
        "ln1": _ln_init(gen, cfg, lead),
        "attn": attn_init(gen, cfg.attn_cfg(False), dtype=cfg.param_dtype,
                          lead=lead),
        "ln2": _ln_init(gen, cfg, lead),
        "mlp": _mlp_init(gen, cfg, lead),
    }


def _dec_layer_init(gen, cfg: EncDecConfig, lead=()):
    return {
        "ln1": _ln_init(gen, cfg, lead),
        "self_attn": attn_init(gen, cfg.attn_cfg(True),
                               dtype=cfg.param_dtype, lead=lead),
        "ln_x": _ln_init(gen, cfg, lead),
        "cross_attn": attn_init(gen, cfg.attn_cfg(False), cross=True,
                                dtype=cfg.param_dtype, lead=lead),
        "ln2": _ln_init(gen, cfg, lead),
        "mlp": _mlp_init(gen, cfg, lead),
    }


def encdec_init(gen: Optional[torch.Generator], cfg: EncDecConfig):
    """Random params drawn from `gen` on its device (gen=None: the ambient
    device, e.g. `torch.device("meta")` for shapes only); each stack's
    layers stacked on a leading n_layers axis."""
    dt, L = cfg.param_dtype, (cfg.n_layers,)
    return {
        "enc_pos": (_randn(gen, (cfg.n_frames, cfg.d_model)) * 0.02).to(dt),
        "dec_embed": embed_init(gen, cfg.vocab, cfg.d_model, dt),
        "dec_pos": (_randn(gen, (cfg.max_target, cfg.d_model))
                    * 0.02).to(dt),
        "enc_layers": _enc_layer_init(gen, cfg, L),
        "dec_layers": _dec_layer_init(gen, cfg, L),
        "enc_ln_post": _ln_init(gen, cfg),
        "dec_ln_post": _ln_init(gen, cfg),
    }


def _enc_layer(cfg: EncDecConfig, x, layers, i):
    cd = cfg.compute_dtype
    lp = layer_params(layers, i)
    h, _ = attn_apply(lp["attn"], cfg.attn_cfg(False),
                      layernorm_apply(lp["ln1"], x), compute_dtype=cd)
    x = x + h
    h = mlp_apply(lp["mlp"], layernorm_apply(lp["ln2"], x),
                  activation="gelu", compute_dtype=cd)
    return x + h


def encode(params, cfg: EncDecConfig, frame_embeds):
    """frame_embeds (B, n_frames, d_model) from the stub frontend ->
    encoder output (B, n_frames, d_model) in compute_dtype."""
    cd = cfg.compute_dtype
    x = frame_embeds.to(cd)
    x = x + fetch(params["enc_pos"]).to(cd)[None, :x.shape[1]]
    layers = unbind_layers(params["enc_layers"])
    for i in range(cfg.n_layers):
        if torch.is_grad_enabled():
            x = checkpoint(_enc_layer, cfg, x, layers, i,
                           use_reentrant=False)
        else:
            x = _enc_layer(cfg, x, layers, i)
    return layernorm_apply(fetch_tree(params["enc_ln_post"]), x)


def _dec_layer(cfg: EncDecConfig, x, layers, i, positions, self_cache,
               cross):
    """Decoder layer i of the unbound `layers`: causal self-attention
    (against `self_cache` when given), cross-attention (`cross` is
    {"kv_x": memory} or {"kv_cache": read-only K/V}), GELU MLP."""
    cd = cfg.compute_dtype
    lp = layer_params(layers, i)
    h, _ = attn_apply(lp["self_attn"], cfg.attn_cfg(True),
                      layernorm_apply(lp["ln1"], x), positions=positions,
                      cache=self_cache, compute_dtype=cd)
    x = x + h
    h, _ = attn_apply(lp["cross_attn"], cfg.attn_cfg(False),
                      layernorm_apply(lp["ln_x"], x), positions=positions,
                      compute_dtype=cd, **cross)
    x = x + h
    h = mlp_apply(lp["mlp"], layernorm_apply(lp["ln2"], x),
                  activation="gelu", compute_dtype=cd)
    return x + h


def _layer_cache(stacked, i, index):
    """Layer i's views of a stacked self-attention cache, with the
    cursor: written in place, they write the stack."""
    c = {k: v[i] for k, v in stacked.items()}
    c["index"] = index
    return c


def _readout(params, cfg: EncDecConfig, x):
    x = layernorm_apply(fetch_tree(params["dec_ln_post"]), x)
    logits = embed_attend(fetch_tree(params["dec_embed"]), x,
                          cfg.compute_dtype)
    return keep_vocab(logits.float(), logits)


def decode(params, cfg: EncDecConfig, tokens, memory, *, caches=None,
           positions=None):
    """tokens (B, S); memory (B, n_frames, d) the encoder output.

    caches: {"self": stacked (L, ...) single-stream caches, "index": 0-d
    cursor} (init_encdec_cache) or None (the training path, every layer
    recomputed in the backward pass). Returns (fp32 logits (B, S,
    vocab), new caches: the same tensors, written, cursor + S)."""
    S = tokens.shape[1]
    if positions is None:
        base = caches["index"] if caches is not None else 0
        positions = base + torch.arange(S, device=tokens.device)
    cd = cfg.compute_dtype
    x = embed_apply(fetch_tree(params["dec_embed"]), tokens, cd)
    pos_table = fetch(params["dec_pos"]).to(cd)
    # decode positions past max_target read the table's last row
    x = x + pos_table[torch.clamp(positions, max=pos_table.shape[0] - 1)
                      .long()]
    layers = unbind_layers(params["dec_layers"])
    remat = caches is None and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        self_cache = (None if caches is None else
                      _layer_cache(caches["self"], i, caches["index"]))
        args = (cfg, x, layers, i, positions, self_cache, {"kv_x": memory})
        x = (checkpoint(_dec_layer, *args, use_reentrant=False) if remat
             else _dec_layer(*args))
    new_caches = None
    if caches is not None:
        new_caches = {"self": caches["self"], "index": caches["index"] + S}
    return _readout(params, cfg, x), new_caches


def encdec_apply(params, cfg: EncDecConfig, frame_embeds, tokens):
    """Training forward: encode, then teacher-forced decode -> fp32
    logits (B, S, vocab)."""
    params = {**params, "dec_embed": fetch_tree(params["dec_embed"])}
    memory = encode(params, cfg, frame_embeds)
    return decode(params, cfg, tokens, memory)[0]


def init_encdec_cache(cfg: EncDecConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, *, per_slot: bool = False,
                      device="cpu", kv_heads: Optional[int] = None):
    """Self-attention decoder caches, stacked (n_layers, ...).

    per_slot=True is the pooled layout the serving engine slices per
    slot: {"slots": {"self": stacked}, "index": (B,)} with a position row
    per slot. The default is the single-stream layout of `decode`:
    {"self": stacked, "index": 0-d}, one position row (L, max_len).
    kv_heads: the heads the cache holds (default n_heads; a model rank's
    share on a serving mesh)."""
    L, H, hd = cfg.n_layers, kv_heads or cfg.n_heads, cfg.head_dim
    if per_slot:
        stacked = init_kv_cache(batch, max_len, H, hd, dtype, device,
                                lead=(L,))
        return {"slots": {"self": stacked},
                "index": torch.zeros((batch,), dtype=torch.int32,
                                     device=device)}
    shape = (L, batch, max_len, H, hd)
    return {"self": {"k": torch.zeros(shape, dtype=dtype, device=device),
                     "v": torch.zeros(shape, dtype=dtype, device=device),
                     "pos": torch.full((L, max_len), -1, dtype=torch.int32,
                                       device=device)},
            "index": torch.zeros((), dtype=torch.int32, device=device)}


def precompute_cross_kv(params, cfg: EncDecConfig, memory):
    """Every decoder layer's cross-attention K/V of one encoder output:
    memory (B, Sm, d) -> k, v each (L, B, Sm, n_heads, head_dim) in
    compute_dtype, the projections attention computes inline from
    kv_x=memory (a model rank's heads where wk / wv are column
    parallel)."""
    hd, cd = cfg.head_dim, cfg.compute_dtype
    ca = unbind_layers(params["dec_layers"]["cross_attn"])
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = layer_params(ca, i)
        k = dense_apply(lp["wk"], memory, cd)
        v = dense_apply(lp["wv"], memory, cd)
        ks.append(k.reshape(*k.shape[:-1], -1, hd))
        vs.append(v.reshape(*v.shape[:-1], -1, hd))
    return torch.stack(ks), torch.stack(vs)


def decode_serve(params, cfg: EncDecConfig, tokens, positions, cache):
    """Pooled (continuous-batching) decode step of the encdec family.

    cache: {"slots": {"self": stacked (L, B, rows, ...) KV}, "index":
    (B,) per-slot cursors, "cross": read-only cross K/V, dense {"k",
    "v" (L, B, Sm, H, hd), "pos"} or the paged arena {"k", "v" (L,
    n_blocks, bs, H, hd), "pos" (n_blocks, bs), "table" (B,
    max_blocks)} (pos and table carry no layer dim: frame positions are
    the same in every layer)}. positions (B, S): per-slot LOCAL decode
    positions (pads < 0), clipped into the position table. The self
    cache is written in place; the cross tree passes through unchanged.
    Returns (fp32 logits (B, S, vocab), cache with cursors + S)."""
    S = tokens.shape[1]
    cd = cfg.compute_dtype
    x = embed_apply(fetch_tree(params["dec_embed"]), tokens, cd)
    pos_table = params["dec_pos"].to(cd)
    x = x + pos_table[torch.clamp(positions, 0,
                                  pos_table.shape[0] - 1).long()]
    cross = cache["cross"]
    cross_ro = {n: t for n, t in cross.items() if n not in ("k", "v")}
    layers = unbind_layers(params["dec_layers"])
    for i in range(cfg.n_layers):
        kv_cache = {"k": cross["k"][i], "v": cross["v"][i], **cross_ro}
        x = _dec_layer(cfg, x, layers, i, positions,
                       _layer_cache(cache["slots"]["self"], i,
                                    cache["index"]),
                       {"kv_cache": kv_cache})
    new_cache = {"slots": cache["slots"], "index": cache["index"] + S,
                 "cross": cross}
    return _readout(params, cfg, x), new_cache


def prefill_serve(params, cfg: EncDecConfig, tokens, positions, frames,
                  cache_len: int, kv_heads: Optional[int] = None):
    """Batched encdec admission: encode, project the cross K/V once, run
    the decoder prompt into fresh per-slot caches of cache_len rows.

    tokens/positions (B, S) left-padded prompts (pads < 0; None: 0..S-1);
    frames (B, n_frames, d_model). Returns (last-position fp32 logits
    (B, 1, V), pooled cache whose "cross" is the DENSE per-request form,
    axis 1 the batch axis of every k/v leaf, so that the engine slices
    one request's cross K/V out for the arena as it slices its self
    rows)."""
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    memory = encode(params, cfg, frames)
    ck, cv = precompute_cross_kv(params, cfg, memory)
    cache = init_encdec_cache(cfg, B, cache_len, dtype=cfg.compute_dtype,
                              per_slot=True, device=tokens.device,
                              kv_heads=kv_heads)
    cache["cross"] = {"k": ck, "v": cv,
                      "pos": torch.arange(memory.shape[1],
                                          dtype=torch.int32,
                                          device=tokens.device)}
    logits, cache = decode_serve(params, cfg, tokens, positions, cache)
    return logits[:, -1:], cache
