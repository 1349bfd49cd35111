"""Arch: binds a model family to its config and to the input shapes of
the dry run (port of repro/configs/base.py).

Every family of the JAX package: the decoders' training (the causal-LM
loss, chunked over the sequence for big vocabularies) and serving (init,
the paged serving cache, prefill into a pooled cache, one decode step);
the encoder-decoder's training (lm_loss over encdec_apply) and serving
(the pooled per-slot self cache, admission prefill that encodes and
projects the cross K/V once, the pooled and single-stream decode
steps); and BERT's pretraining and scoring forward (`score`).

The dry run's surface (launch/dryrun.py) builds everything on the meta
device, so that nothing is allocated: `abstract_params` (init under
torch.device("meta")), `input_specs`, `cache_specs` and
`paged_cache_specs` of the four assigned input shapes:
  train_4k     seq 4096    global_batch 256   -> train step
  prefill_32k  seq 32768   global_batch 32    -> prefill step
  decode_32k   seq 32768   global_batch 128   -> serve step (1 new token)
  long_500k    seq 524288  global_batch 1     -> serve step; archs with
                                                 long_context_ok only
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from repro_torch.models import bert as bert_lib
from repro_torch.models import decoder as dec_lib
from repro_torch.models import encdec as ed_lib
from repro_torch.models.common import WHOLE, fetch_tree


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class Arch:
    name: str
    kind: str                      # "decoder" | "encdec" | "bert"
    cfg: Any
    source: str                    # citation for the config
    zero3: bool = False            # FSDP over the data axis (>=100B params)
    zero1: bool = False            # ZeRO-1: moments cut over "data" too
    long_context_ok: bool = False  # sub-quadratic / windowed: long_500k
    embeds_input: bool = False     # VLM stub: the model takes embeddings
    train_microbatches: int = 4    # grad-accum splits of the global batch

    @property
    def heads(self) -> tuple:
        """(n_heads, n_kv, head_dim) of the attention: what a mesh's use
        plan needs to split it over "model" on whole heads or in head
        groups (distributed/sharding.py: head_groups, use_plan)."""
        cfg = self.cfg
        n_kv = getattr(cfg, "n_kv_heads", cfg.n_heads)
        return (cfg.n_heads, n_kv,
                getattr(cfg, "resolved_head_dim", None) or cfg.head_dim)

    @property
    def mamba(self):
        """The Mamba-2 mixer's config (models/mamba2.py: MambaConfig:
        its heads and groups) of a decoder with Mamba slots, else None:
        what a mesh's use plan needs to cut the mixer over "model" on
        whole heads (distributed/sharding.py: use_plan)."""
        if self.kind != "decoder" or all(
                mixer != "mamba" for mixer, _ in self.cfg.superblock):
            return None
        return self.cfg.mamba_cfg()

    def init(self, gen: torch.Generator):
        """Random params drawn from `gen`, on `gen.device`."""
        if self.kind == "bert":
            return bert_lib.bert_init(gen, self.cfg)
        if self.kind == "encdec":
            return ed_lib.encdec_init(gen, self.cfg)
        return dec_lib.decoder_init(gen, self.cfg)

    def loss_fn(self, params, batch):
        """(loss, aux) for one batch — what the train step
        differentiates. Decoders: next-token cross entropy of
        batch["labels"] given batch["tokens"] (or batch["embeds"] for an
        embeds_input arch), chunked over the sequence (the (B, S, V)
        logits never live at once) when the vocab is >= 65536 and the
        sequence is >= 1024 and a multiple of 512, the JAX package's
        rule. Encdec: the same cross entropy of the decoder given
        batch["frames"] and batch["tokens"], no aux. A batch that is a
        block of a larger one carries that one under WHOLE, and the mean
        is taken over its valid labels (models/common.py); the MoE aux
        terms are then the block's parts of the whole batch's
        (models/moe.py)."""
        if self.kind == "bert":
            return bert_lib.bert_pretrain_loss(params, self.cfg, batch)
        whole = batch.get(WHOLE)
        count = None if whole is None else (whole["labels"] != -100).sum()
        if self.kind == "encdec":
            logits = ed_lib.encdec_apply(params, self.cfg, batch["frames"],
                                         batch["tokens"])
            return dec_lib.lm_loss(logits, batch["labels"], count=count), {}
        # the embedding and the readout fetched once (models/common.py:
        # fetch): a tied embedding serves the lookup and every chunk of
        # the head with one gather
        if isinstance(params, dict):
            params = {**params, **{k: fetch_tree(params[k]) for k in
                                   ("embed", "lm_head") if k in params}}
        seq = batch["labels"].shape[1]
        chunked = (self.cfg.vocab >= 65536 and seq >= 1024
                   and seq % 512 == 0)
        kw = (dict(embeds=batch["embeds"])
              if self.embeds_input and "embeds" in batch
              else dict(tokens=batch["tokens"]))
        if chunked:
            hidden, _, aux = dec_lib.decoder_apply(
                params, self.cfg, return_hidden=True, **kw)
            loss = dec_lib.chunked_lm_loss(params, self.cfg, hidden,
                                           batch["labels"],
                                           moe_aux=aux["moe_aux_loss"],
                                           count=count)
        else:
            logits, _, aux = dec_lib.decoder_apply(params, self.cfg, **kw)
            loss = dec_lib.lm_loss(logits, batch["labels"],
                                   moe_aux=aux["moe_aux_loss"], count=count)
        return loss, {"router_entropy": aux["router_entropy"]}

    def init_cache(self, batch: int, max_len: int, *, device="cpu",
                   clamp_window: bool = True,
                   kv_heads: Optional[int] = None, mamba_ranks: int = 1):
        """Pooled per-slot serving cache: `batch` slots of max_len rows
        (decoders: window-sized rings on sliding-window layers unless
        clamp_window=False, the chunked prefill's cache; encdec: the
        self-attention cache in compute_dtype), cursors at 0. kv_heads:
        the KV heads it holds (default all; a model rank's share on a
        serving mesh); mamba_ranks: the ranks a decoder's Mamba heads are
        cut over there (its state then holds the rank's heads)."""
        if self.kind == "encdec":
            return ed_lib.init_encdec_cache(self.cfg, batch, max_len,
                                            dtype=self.cfg.compute_dtype,
                                            per_slot=True, device=device,
                                            kv_heads=kv_heads)
        if self.kind != "decoder":
            raise ValueError(f"{self.kind} has no decode cache")
        return dec_lib.init_decoder_cache(self.cfg, batch, max_len,
                                          device=device,
                                          clamp_window=clamp_window,
                                          kv_heads=kv_heads,
                                          mamba_ranks=mamba_ranks)

    def init_paged_cache(self, batch: int, max_len: int, *,
                         block_size: int = 16, n_blocks=None, device="cpu",
                         row_margin: int = 0,
                         kv_heads: Optional[int] = None,
                         mamba_ranks: int = 1):
        """Paged (block-arena) serving cache, decoder-only. n_blocks
        defaults to the dense-equivalent budget: `batch` slots' worth of
        blocks per attention slot-type. row_margin widens the rings
        (speculative decoding; models/decoder.paged_layout). kv_heads and
        mamba_ranks as init_cache's."""
        if self.kind != "decoder":
            raise NotImplementedError("paged serving is decoder-only")
        if n_blocks is None:
            layout = dec_lib.paged_layout(self.cfg, max_len, block_size,
                                          row_margin)
            n_blocks = {si: batch * (ring // block_size)
                        for si, ring in filter(None, layout)}
        return dec_lib.init_paged_decoder_cache(
            self.cfg, batch, max_len, block_size=block_size,
            n_blocks=n_blocks, device=device, row_margin=row_margin,
            kv_heads=kv_heads, mamba_ranks=mamba_ranks)

    def prefill(self, params, batch, *, cache_len: Optional[int] = None,
                positions=None, per_slot: bool = True,
                kv_heads: Optional[int] = None, mamba_ranks: int = 1):
        """Full-sequence forward into a fresh cache -> (last-position
        logits (B, 1, V), cache). positions (B, S) gives per-slot local
        timelines; left-pad rows carry positions < 0.

        Encdec also takes batch["frames"]: with per_slot (the pooled
        serving admission) it encodes, projects the cross K/V once and
        returns them dense under cache["cross"]; per_slot=False is the
        single-stream form (a 0-d cursor; decode_step then takes the
        encoder output as batch["memory"]). Decoders serve pooled only.
        kv_heads, mamba_ranks: the pooled cache's (init_cache's)."""
        toks = batch["tokens"]
        if self.kind == "encdec":
            if per_slot:
                return ed_lib.prefill_serve(
                    params, self.cfg, toks, positions, batch["frames"],
                    cache_len or toks.shape[1], kv_heads=kv_heads)
            memory = ed_lib.encode(params, self.cfg, batch["frames"])
            cache = ed_lib.init_encdec_cache(
                self.cfg, toks.shape[0], cache_len or toks.shape[1],
                device=toks.device)
            logits, cache = ed_lib.decode(params, self.cfg, toks, memory,
                                          caches=cache)
            return logits[:, -1:], cache
        if self.kind != "decoder":
            raise ValueError(f"{self.kind} does not serve")
        if not per_slot:
            raise ValueError("decoders serve from the pooled (per-slot) "
                             "cache only")
        cache = dec_lib.init_decoder_cache(
            self.cfg, toks.shape[0], cache_len or toks.shape[1],
            device=toks.device, kv_heads=kv_heads, mamba_ranks=mamba_ranks)
        logits, cache, _ = dec_lib.decoder_apply(params, self.cfg, toks,
                                                 caches=cache,
                                                 positions=positions)
        return logits[:, -1:], cache

    def decode_step(self, params, batch, cache):
        """New tokens against the cache -> (logits, cache written in
        place). batch may carry "positions" (B, S). Encdec: a pooled
        cache ("slots") carries its cross K/V; the single-stream one
        takes batch["memory"], the encoder output."""
        if self.kind == "encdec":
            if "slots" in cache:
                return ed_lib.decode_serve(params, self.cfg,
                                           batch["tokens"],
                                           batch["positions"], cache)
            return ed_lib.decode(params, self.cfg, batch["tokens"],
                                 batch["memory"], caches=cache)
        if self.kind != "decoder":
            raise ValueError(f"{self.kind} does not serve")
        logits, cache, _ = dec_lib.decoder_apply(
            params, self.cfg, batch["tokens"], caches=cache,
            positions=batch.get("positions"))
        return logits, cache

    def score(self, params, tokens, positions):
        """Batched scoring forward (BERT) -> (masked-LM argmax ids (B, S)
        int32, fp32 tanh-pooled [CLS] embedding (B, d)). tokens /
        positions (B, S) left-padded (pads < 0); no cache."""
        if self.kind != "bert":
            raise ValueError(f"{self.kind} has no scoring forward")
        return bert_lib.bert_serve_outputs(params, self.cfg, tokens,
                                           positions)

    # ---------------- the dry run's shapes (meta tensors) ----------------

    def supports(self, shape_name: str) -> bool:
        shape = SHAPES[shape_name]
        if self.kind == "bert" and shape.kind != "train":
            return False
        if shape.name == "long_500k":
            return self.long_context_ok
        return True

    def skip_reason(self, shape_name: str) -> str:
        """Why the dry run skips a shape that `supports` refuses (the JAX
        dry run's words)."""
        shape = SHAPES[shape_name]
        return ("long_500k requires sub-quadratic attention"
                if shape_name == "long_500k"
                else f"{self.kind} has no {shape.kind} step")

    def input_specs(self, shape_name: str) -> dict:
        """Meta-tensor stand-ins for every model input of this shape."""
        shape = SHAPES[shape_name]
        B, S = shape.global_batch, shape.seq_len
        i32 = lambda *s: torch.empty(s, dtype=torch.int32, device=META)
        f32 = lambda *s: torch.empty(s, dtype=torch.float32, device=META)
        if self.kind == "bert":
            return {"tokens": i32(B, S), "token_types": i32(B, S),
                    "mlm_labels": i32(B, S), "nsp_labels": i32(B)}
        if self.kind == "encdec":
            frames = f32(B, self.cfg.n_frames, self.cfg.d_model)
            if shape.kind == "train":
                return {"frames": frames, "tokens": i32(B, S),
                        "labels": i32(B, S)}
            if shape.kind == "prefill":
                return {"frames": frames, "tokens": i32(B, S)}
            return {"tokens": i32(B, 1), "memory": frames}
        if shape.kind == "train":
            if self.embeds_input:
                return {"embeds": f32(B, S, self.cfg.d_model),
                        "labels": i32(B, S)}
            return {"tokens": i32(B, S), "labels": i32(B, S)}
        if shape.kind == "prefill":
            return {"tokens": i32(B, S)}
        return {"tokens": i32(B, 1)}

    def cache_specs(self, shape_name: str):
        """The dense decode cache of this shape, on the meta device: the
        encoder-decoder's single-stream cache (its decode step then takes
        the encoder output as batch["memory"]), a decoder's pooled one
        (the port's decoders serve pooled only: a (B,) cursor and (B, L)
        position rows where the JAX package's single-stream cache has a
        0-d cursor and (L,) rows)."""
        shape = SHAPES[shape_name]
        B, S = shape.global_batch, shape.seq_len
        if self.kind == "encdec":
            return ed_lib.init_encdec_cache(self.cfg, B, S,
                                            dtype=self.cfg.compute_dtype,
                                            device=META)
        return self.init_cache(B, S, device=META)

    def paged_cache_specs(self, shape_name: str, *, block_size: int = 16,
                          batch: Optional[int] = None, layout=None):
        """The paged cache the dry run's decode shapes serve from, on the
        meta device. One device: each arena one null block short of the
        dense-equivalent budget, as in the JAX package. With a serving
        mesh's ServeLayout (distributed/sharding.py), one data rank's
        pool as serving/cache_pool.py builds it for `batch` slots
        (default the shape's global batch): its rows, its share of every
        arena's blocks, its KV heads and its Mamba heads."""
        shape = SHAPES[shape_name]
        B = batch or shape.global_batch
        layout_ = dec_lib.paged_layout(self.cfg, shape.seq_len, block_size)
        if layout is None:
            n_blocks = {si: B * (ring // block_size) - 1
                        for si, ring in filter(None, layout_)}
            return self.init_paged_cache(B, shape.seq_len,
                                         block_size=block_size,
                                         n_blocks=n_blocks, device=META)
        n_blocks = {si: B * (ring // block_size) // layout.data
                    for si, ring in filter(None, layout_)}
        return self.init_paged_cache(
            layout.rows, shape.seq_len, block_size=block_size,
            n_blocks=n_blocks, device=META,
            **layout.cache_kw(self.heads[1]))

    def abstract_params(self):
        """The params' tree at full size on the meta device."""
        with torch.device("meta"):
            return self.init(None)

    def param_count(self) -> int:
        from repro_torch.core.optim.base import tree_leaves
        return sum(math.prod(t.shape)
                   for t in tree_leaves(self.abstract_params()))


def reduced_decoder(cfg: dec_lib.DecoderConfig, **over):
    """Smoke-test variant (the JAX package's reduced_decoder): two layers,
    or one period of a longer superblock; d_model 256, 4 heads of 64,
    vocab 1k, max_seq 256, fp32 params; d_ff 512, or 256 with experts (at
    most 4 of them, top-k at most 2); Mamba slots with d_inner 512,
    headdim 64, dstate 32 and chunk 16."""
    n_slots = len(cfg.superblock)
    small = dict(
        n_layers=max(2, n_slots) if n_slots > 1 else 2,
        d_model=256,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2),
        head_dim=64,
        d_ff=512 if cfg.n_experts == 0 else 256,
        vocab=1024,
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        mamba_d_inner=512 if cfg.mamba_d_inner else None,
        mamba_headdim=64,
        mamba_dstate=32,
        mamba_chunk=16,
        sliding_window=16 if cfg.sliding_window else None,
        max_seq=256,
        param_dtype=torch.float32,  # smoke numerics even for bf16 configs
    )
    small.update(over)
    if small["n_layers"] % n_slots != 0:
        small["n_layers"] = n_slots * max(1, small["n_layers"] // n_slots)
    return dataclasses.replace(cfg, **small)
