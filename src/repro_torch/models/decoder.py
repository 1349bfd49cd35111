"""Decoder-only LM (port of repro/models/decoder.py): the dense, MoE and
hybrid (attention / Mamba-2) decoders.

The layer stack is a repeating SUPERBLOCK of (mixer, ffn) slots, e.g.
gemma2's (("attn_local", "mlp"), ("attn", "mlp")) x 13 periods, or
jamba's eight slots with one attention mixer, seven Mamba mixers and an
MoE ffn on every other slot. As in the JAX package, each slot's params
are stacked over the periods (`params["slot{i}"]` leaves have a leading
n_periods dim) and so are its caches; where JAX scans over periods, the
port runs a Python loop and hands each layer the period's view of each
stacked leaf: one unbind per leaf per forward, so the backward pass
stacks a leaf's gradient once (indexing it period by period would build
a zero gradient the size of the whole stack per period), and on the
paged path a contiguous slice, which the kernel writes in place. In
training (no cache, grad enabled) each period is recomputed in the
backward pass (`cfg.remat`, as the JAX package's `jax.checkpoint(...,
nothing_saveable)` over its scan). On a mesh a period's leaves are
fetched inside that recomputed region (models/common.py: layer_params).

Slots: mixers "attn" / "attn_local" (with QK-norm) and "mamba"; ffns
"mlp", "moe" and "none" (mixer-only blocks, mamba2). Tied or untied
(`lm_head`) readouts, token or embedding inputs, and the losses
`lm_loss` and `chunked_lm_loss`. The MoE aux terms (moe_aux_loss,
router_entropy) are summed over the periods; they stay 0 for archs
without experts. Left padding is marked by negative positions: attention
masks it by position, Mamba and MoE by the `valid` mask derived from
(B, S) positions.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.metrics.spans import span
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba2 as mamba_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.attention import AttnConfig, attn_apply, attn_init
from repro_torch.models.common import (dense_apply, dense_init, embed_apply,
                                       embed_attend, embed_init, fetch_tree,
                                       keep_vocab, layer_params,
                                       log_likelihood, mlp_apply, mlp_init,
                                       rmsnorm_apply, rmsnorm_init, softcap,
                                       unbind_layers)


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
    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None       # window of "attn_local" slots
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    post_block_norm: bool = False
    attn_kernel: str = "xla"                   # paged decode: "xla" | "paged"
    # "paged" through the plain version (attention.py); None, as in the
    # JAX config this one equals field by field, is off
    kernel_interpret: Optional[bool] = None

    activation: str = "silu"
    gated_mlp: bool = True

    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    mamba_d_inner: Optional[int] = None
    mamba_headdim: int = 64
    mamba_dstate: int = 128
    mamba_chunk: int = 64

    # (mixer, ffn) slots: mixer in {"attn", "attn_local", "mamba"}, ffn in
    # {"mlp", "moe", "none"}
    superblock: Tuple[Tuple[str, str], ...] = (("attn", "mlp"),)

    tie_embeddings: bool = True
    scale_embeds: bool = False
    remat: bool = True                         # recompute each period in bwd
    max_seq: int = 8192
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
            qkv_bias=self.qkv_bias, qk_norm=self.qk_norm,
            rope_theta=self.rope_theta,
            sliding_window=self.sliding_window if local else None,
            logit_softcap=self.attn_softcap,
            decode_kernel=self.attn_kernel,
            kernel_interpret=bool(self.kernel_interpret))

    def moe_cfg(self) -> moe_lib.MoeConfig:
        return moe_lib.MoeConfig(
            d_model=self.d_model, d_ff=self.d_ff, n_experts=self.n_experts,
            top_k=self.top_k, capacity_factor=self.capacity_factor,
            activation=self.activation, gated=self.gated_mlp)

    def mamba_cfg(self) -> mamba_lib.MambaConfig:
        return mamba_lib.MambaConfig(
            d_model=self.d_model,
            d_inner=self.mamba_d_inner or 2 * self.d_model,
            headdim=self.mamba_headdim, dstate=self.mamba_dstate,
            chunk=self.mamba_chunk)


def _slot_init(gen, cfg: DecoderConfig, mixer: str, ffn: str):
    lead = (cfg.n_periods,)
    dev, dt = (None if gen is None else gen.device), cfg.param_dtype
    p = {"pre_mixer_norm": rmsnorm_init(cfg.d_model, dt, dev, lead),
         "pre_ffn_norm": rmsnorm_init(cfg.d_model, dt, dev, lead)}
    if cfg.post_block_norm:
        p["post_mixer_norm"] = rmsnorm_init(cfg.d_model, dt, dev, lead)
        p["post_ffn_norm"] = rmsnorm_init(cfg.d_model, dt, dev, lead)
    if mixer in ("attn", "attn_local"):
        p["mixer"] = attn_init(gen, cfg.attn_cfg(mixer == "attn_local"),
                               dtype=dt, lead=lead)
    elif mixer == "mamba":
        p["mixer"] = mamba_lib.mamba_init(gen, cfg.mamba_cfg(), dt, lead)
    else:
        raise ValueError(f"unknown mixer {mixer!r}")
    if ffn == "mlp":
        p["ffn"] = mlp_init(gen, cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp,
                            dtype=dt, lead=lead)
    elif ffn == "moe":
        p["ffn"] = moe_lib.moe_init(gen, cfg.moe_cfg(), dt, lead)
    elif ffn == "none":          # mixer-only blocks (mamba2)
        p.pop("pre_ffn_norm")
        p.pop("post_ffn_norm", None)
    else:
        raise ValueError(f"unknown ffn {ffn!r}")
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
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab,
                                       dtype=cfg.param_dtype)
    for si, (mixer, ffn) in enumerate(cfg.superblock):
        params[f"slot{si}"] = _slot_init(gen, cfg, mixer, ffn)
    return params


def _run_slot(sp, cfg: DecoderConfig, mixer: str, ffn: str, x, positions,
              cache, valid):
    """One (mixer, ffn) slot -> (x, MoE aux terms or None). valid (B, S)
    bool or None: False marks left padding, which Mamba and MoE must keep
    out of their state and routing (attention masks it by position)."""
    h = rmsnorm_apply(sp["pre_mixer_norm"], x)
    if mixer == "mamba":
        out, _ = mamba_lib.mamba_apply(sp["mixer"], cfg.mamba_cfg(), h,
                                       cache=cache, valid=valid,
                                       compute_dtype=cfg.compute_dtype)
    else:
        out, _ = attn_apply(sp["mixer"], cfg.attn_cfg(mixer == "attn_local"),
                            h, positions=positions, cache=cache,
                            compute_dtype=cfg.compute_dtype)
    if cfg.post_block_norm:
        out = rmsnorm_apply(sp["post_mixer_norm"], out)
    x = x + out
    if ffn == "none":
        return x, None
    h = rmsnorm_apply(sp["pre_ffn_norm"], x)
    aux = None
    if ffn == "moe":
        out, aux = moe_lib.moe_apply(sp["ffn"], cfg.moe_cfg(), h,
                                     valid=valid,
                                     compute_dtype=cfg.compute_dtype)
    else:
        out = mlp_apply(sp["ffn"], h, activation=cfg.activation,
                        compute_dtype=cfg.compute_dtype)
    if cfg.post_block_norm:
        out = rmsnorm_apply(sp["post_ffn_norm"], out)
    return x + out, aux


def _run_period(cfg: DecoderConfig, x, positions, valid, slots, p,
                caches):
    """Period p: the superblock's slots in order. slots[si] is slot si's
    params unbound over the periods, caches[si] its cache or None.
    Returns (x, this period's summed moe_aux_loss, router_entropy), the
    sums None when the superblock has no MoE slot."""
    slot_params = [layer_params(sp, p) for sp in slots]
    aux_loss = entropy = None
    for si, (mixer, ffn) in enumerate(cfg.superblock):
        x, aux = _run_slot(slot_params[si], cfg, mixer, ffn, x, positions,
                           caches[si], valid)
        if aux is not None:
            aux_loss = _add(aux_loss, aux["moe_aux_loss"])
            entropy = _add(entropy, aux["router_entropy"])
    return x, aux_loss, entropy


def _add(total, term):
    """total + term, where a None total is no sum yet."""
    return term if total is None else total + term


def decoder_apply(params, cfg: DecoderConfig, tokens=None, *, embeds=None,
                  positions=None, caches=None, return_hidden=False):
    """Forward pass -> (logits fp32 (B, S, vocab), new_caches, aux).

    tokens (B, S) int, or embeds (B, S, d_model): precomputed input
    embeddings (the VLM stub). caches: from init_decoder_cache (per-slot
    dense) or init_paged_decoder_cache; they are written in place and
    returned with the advanced index (None without caches). aux holds the
    MoE terms moe_aux_loss and router_entropy, summed over the periods
    (0 without experts).
    With return_hidden the first element is the final-norm hidden states
    (B, S, d_model) instead of the logits (see chunked_lm_loss)."""
    if (tokens is None) == (embeds is None):
        raise ValueError("pass exactly one of tokens and embeds")
    if embeds is None:
        x = embed_apply(fetch_tree(params["embed"]), tokens,
                        cfg.compute_dtype)
        if cfg.scale_embeds:
            x = x * torch.sqrt(torch.tensor(float(cfg.d_model))).to(
                cfg.compute_dtype)
    else:
        x = embeds.to(cfg.compute_dtype)
    B, S = x.shape[:2]
    if positions is None:
        ar = torch.arange(S, device=x.device)
        positions = (caches["index"][:, None] + ar if caches is not None
                     else ar)
    # per-slot positions mark left padding negative: attention masks it
    # by position, Mamba and MoE by this mask
    valid = positions >= 0 if positions.ndim == 2 else None
    tables = caches.get("tables") if caches is not None else None
    # unbound once, outside the recomputed regions (see the module doc)
    slots = [unbind_layers(params[f"slot{si}"])
             for si in range(len(cfg.superblock))]
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    aux_loss = entropy = None

    for p in range(cfg.n_periods):
        slot_caches = [None] * len(cfg.superblock)
        if caches is not None:
            for si, stack in enumerate(caches["slots"]):
                c = {k: v[p] for k, v in stack.items()}
                c["index"] = caches["index"]
                if tables is not None and tables[si] is not None:
                    c["table"] = tables[si]
                slot_caches[si] = c
        if remat:
            x, al, en = checkpoint(_run_period, cfg, x, positions, valid,
                                   slots, p, slot_caches,
                                   use_reentrant=False)
        else:
            x, al, en = _run_period(cfg, x, positions, valid, slots, p,
                                    slot_caches)
        if al is not None:
            aux_loss, entropy = _add(aux_loss, al), _add(entropy, en)

    new_caches = None
    if caches is not None:
        new_caches = {"slots": caches["slots"],
                      "index": caches["index"] + S}
        if tables is not None:
            new_caches["tables"] = tables
    if aux_loss is None:                   # no experts: the terms are 0
        aux_loss = entropy = torch.zeros((), dtype=torch.float32,
                                         device=x.device)
    aux = {"moe_aux_loss": aux_loss, "router_entropy": entropy}
    x = rmsnorm_apply(fetch_tree(params["final_norm"]), x)
    if return_hidden:
        return x, new_caches, aux
    return _head_logits(params, cfg, x), new_caches, aux


def _head_logits(params, cfg: DecoderConfig, x):
    with span("model.head"):
        if cfg.tie_embeddings:
            logits = embed_attend(fetch_tree(params["embed"]), x,
                                  cfg.compute_dtype)
        else:
            logits = dense_apply(fetch_tree(params["lm_head"]), x,
                                 cfg.compute_dtype)
        # on a mesh whose model axis cuts the vocab: the rank's columns
        return keep_vocab(softcap(logits.float(), cfg.final_softcap),
                          logits)


def _token_nll(logits, labels, ignore_id: int):
    """(sum over the valid rows of -log p(label), count of valid rows),
    the log-softmax in fp32 (vocab-parallel on a rank's columns:
    models/common.py: log_likelihood)."""
    valid = labels != ignore_id
    safe = torch.where(valid, labels, 0).long()
    ll = log_likelihood(logits, safe)
    return -(ll * valid).sum(), valid.sum()


def lm_loss(logits, labels, *, ignore_id: int = -100, moe_aux=None,
            aux_weight: float = 0.01, count=None):
    """Next-token cross entropy in fp32 over the labels that are not
    ignore_id (labels already shifted by the data pipeline), plus
    aux_weight * moe_aux when given. `count`, when given, is the number
    of valid labels the mean is taken over in place of these labels'
    (a block of a larger batch: that batch's count)."""
    with span("model.head"):
        total, n_valid = _token_nll(logits, labels, ignore_id)
        loss = total / torch.clamp(n_valid if count is None else count,
                                   min=1)
        if moe_aux is not None:
            loss = loss + aux_weight * moe_aux
        return loss


def _chunk_nll(params, cfg: DecoderConfig, hidden, labels, ignore_id: int):
    return _token_nll(_head_logits(params, cfg, hidden), labels,
                      ignore_id)[0]


def chunked_lm_loss(params, cfg: DecoderConfig, hidden, labels, *,
                    ignore_id: int = -100, chunk: int = 512, moe_aux=None,
                    aux_weight: float = 0.01, count=None):
    """lm_loss of the head's logits of `hidden` (B, S, d_model) without
    materialising the (B, S, V) logits: `chunk` positions at a time, each
    chunk's head, softcap and log-softmax recomputed in the backward
    pass, so only (B, chunk, V) logits are ever live (a rank's (B,
    chunk, V / m) where the model axis cuts the vocab). An fp32 total and
    an integer count of valid labels (or `count`, as lm_loss takes it),
    then total / max(count, 1)."""
    B, S, _ = hidden.shape
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of chunk {chunk}")
    with span("model.head"):
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        n_valid = torch.zeros((), dtype=torch.int64, device=hidden.device)
        for i in range(0, S, chunk):
            h, lab = hidden[:, i:i + chunk], labels[:, i:i + chunk]
            if torch.is_grad_enabled():
                s = checkpoint(_chunk_nll, params, cfg, h, lab, ignore_id,
                               use_reentrant=False)
            else:
                s = _chunk_nll(params, cfg, h, lab, ignore_id)
            total = total + s
            n_valid = n_valid + (lab != ignore_id).sum()
        loss = total / torch.clamp(n_valid if count is None else count,
                                   min=1)
        if moe_aux is not None:
            loss = loss + aux_weight * moe_aux
        return loss


def init_decoder_cache(cfg: DecoderConfig, batch: int, max_len: int,
                       dtype=torch.bfloat16, *, device="cpu",
                       clamp_window: bool = True,
                       kv_heads: Optional[int] = None,
                       mamba_ranks: int = 1):
    """Pooled per-slot caches stacked per superblock slot; "attn_local"
    slots get ring buffers of the window size. KV is stored in `dtype`
    (bf16 by default, as in the JAX package, whatever the compute
    precision).

    clamp_window=False gives "attn_local" slots the full max_len rows
    too: the chunk-resumable prefill cache (serving/admission.py). Every
    prompt chunk then takes attention's incremental write path, never
    the roll branch (which assumes a prefill from scratch), the window
    is enforced by the mask instead of the ring, and the paged pool's
    insert picks the window's tail out of the full-length rows. Mamba
    slots hold their fp32 SSM state and conv tail per batch slot
    (models/mamba2.init_mamba_cache), stacked over the periods. kv_heads
    (default n_kv_heads): the KV heads the attention caches hold, a model
    rank's share on a serving mesh (distributed/sharding.py:
    ServeLayout); mamba_ranks: the ranks the Mamba heads are cut over
    there, a rank's state then its heads' and channels'
    (mamba2.local_cfg)."""
    n_kv = kv_heads or cfg.n_kv_heads
    slots = []
    for mixer, _ in cfg.superblock:
        if mixer == "mamba":
            slots.append(mamba_lib.init_mamba_cache(
                batch, mamba_lib.local_cfg(cfg.mamba_cfg(), mamba_ranks),
                device=device, lead=(cfg.n_periods,)))
            continue
        L = max_len
        if clamp_window and mixer == "attn_local" and cfg.sliding_window:
            L = min(max_len, cfg.sliding_window)
        slots.append(attn_lib.init_kv_cache(
            batch, L, n_kv, cfg.resolved_head_dim, dtype,
            device, lead=(cfg.n_periods,)))
    return {"slots": tuple(slots),
            "index": torch.zeros((batch,), dtype=torch.int32, device=device)}


def paged_layout(cfg: DecoderConfig, max_len: int, block_size: int,
                 row_margin: int = 0):
    """Per-superblock-slot paged layout: [(slot_idx, ring_len) | None].
    An attention slot's ring is max_len rows, or the sliding window for
    "attn_local" slots. Mamba slots give None: their state is O(1) per
    batch slot, so paging buys nothing and it stays slot-resident.

    row_margin > 0 widens every ring by that many rows, rounded up to
    whole blocks: the speculative verify step writes its K rows before
    attention reads, so a ring needs K - 1 rows beyond what any live
    query still attends to (window + K - 1 for sliding-window rings;
    max_len + K - 1 for full rings, which a budget-truncated final round
    still writes up to cursor + K - 1)."""
    margin = -(-row_margin // block_size) * block_size if row_margin else 0
    out = []
    for si, (mixer, _) in enumerate(cfg.superblock):
        if mixer == "mamba":
            out.append(None)
            continue
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
                             row_margin: int = 0,
                             kv_heads: Optional[int] = None,
                             mamba_ranks: int = 1):
    """Paged cache: per attention slot-type a (n_periods, n_blocks + 1,
    block_size, ...) arena (block 0 the null block) and a (batch,
    ring_len // block_size) int32 table of zeros; per Mamba slot-type the
    slot-resident (n_periods, batch, ...) state of init_decoder_cache and
    a None table; per-slot LOCAL write cursors under "index". n_blocks:
    data blocks per arena, an int or {slot_idx: int}. row_margin widens
    the rings (paged_layout). kv_heads and mamba_ranks as
    init_decoder_cache's."""
    slots, tables = [], []
    for si, layout in enumerate(paged_layout(cfg, max_len, block_size,
                                             row_margin)):
        if layout is None:
            slots.append(mamba_lib.init_mamba_cache(
                batch, mamba_lib.local_cfg(cfg.mamba_cfg(), mamba_ranks),
                device=device, lead=(cfg.n_periods,)))
            tables.append(None)
            continue
        _, ring_len = layout
        nb = n_blocks[si] if isinstance(n_blocks, dict) else n_blocks
        slots.append(attn_lib.init_paged_kv_cache(
            nb + 1, block_size, kv_heads or cfg.n_kv_heads,
            cfg.resolved_head_dim,
            dtype, device, lead=(cfg.n_periods,)))
        tables.append(torch.zeros((batch, ring_len // block_size),
                                  dtype=torch.int32, device=device))
    return {"slots": tuple(slots), "tables": tuple(tables),
            "index": torch.zeros((batch,), dtype=torch.int32, device=device)}
