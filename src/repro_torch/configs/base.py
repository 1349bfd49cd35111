"""Arch: binds a model family to its config (port of repro/configs/base.py).

Ported: the decoder family's serving side (init, the paged serving
cache, prefill into a pooled cache, one decode step) and the bert
family's pretraining side (init, loss). The decoder losses and BERT
serving are not ported yet and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.models import bert as bert_lib
from repro_torch.models import decoder as dec_lib


@dataclasses.dataclass(frozen=True)
class Arch:
    name: str
    kind: str                      # "decoder" | "bert"
    cfg: Any
    source: str                    # citation for the config

    def init(self, gen: torch.Generator):
        """Random params drawn from `gen`, on `gen.device`."""
        if self.kind == "bert":
            return bert_lib.bert_init(gen, self.cfg)
        return dec_lib.decoder_init(gen, self.cfg)

    def loss_fn(self, params, batch):
        """(loss, aux) for one batch — what the train step
        differentiates."""
        if self.kind != "bert":
            raise NotImplementedError(f"training the {self.kind} family is "
                                      f"not ported yet")
        return bert_lib.bert_pretrain_loss(params, self.cfg, batch)

    def _serving(self):
        if self.kind != "decoder":
            raise NotImplementedError(f"serving the {self.kind} family is "
                                      f"not ported yet")

    def init_cache(self, batch: int, max_len: int, *, device="cpu"):
        """Pooled per-slot serving cache: `batch` slots of max_len rows
        (window-sized rings on sliding-window layers), cursors at 0."""
        self._serving()
        return dec_lib.init_decoder_cache(self.cfg, batch, max_len,
                                          device=device)

    def init_paged_cache(self, batch: int, max_len: int, *,
                         block_size: int = 16, n_blocks=None, device="cpu",
                         row_margin: int = 0):
        """Paged (block-arena) serving cache. n_blocks defaults to the
        dense-equivalent budget: `batch` slots' worth of blocks per
        attention slot-type. row_margin widens the rings (speculative
        decoding; models/decoder.paged_layout)."""
        self._serving()
        if n_blocks is None:
            n_blocks = {si: batch * (ring // block_size) for si, ring
                        in dec_lib.paged_layout(self.cfg, max_len,
                                                block_size, row_margin)}
        return dec_lib.init_paged_decoder_cache(
            self.cfg, batch, max_len, block_size=block_size,
            n_blocks=n_blocks, device=device, row_margin=row_margin)

    def prefill(self, params, batch, *, cache_len: Optional[int] = None,
                positions=None):
        """Full-sequence forward into a fresh pooled cache ->
        (last-position logits (B, 1, V), cache). positions (B, S) gives
        per-slot local timelines; left-pad rows carry positions < 0."""
        self._serving()
        toks = batch["tokens"]
        cache = dec_lib.init_decoder_cache(
            self.cfg, toks.shape[0], cache_len or toks.shape[1],
            device=toks.device)
        logits, cache = dec_lib.decoder_apply(params, self.cfg, toks,
                                              caches=cache,
                                              positions=positions)
        return logits[:, -1:], cache

    def decode_step(self, params, batch, cache):
        """New tokens against the cache -> (logits, cache written in
        place). batch may carry "positions" (B, S)."""
        self._serving()
        return dec_lib.decoder_apply(params, self.cfg, batch["tokens"],
                                     caches=cache,
                                     positions=batch.get("positions"))


def reduced_decoder(cfg: dec_lib.DecoderConfig, **over):
    """Smoke-test variant: one superblock period x2, d_model 256, vocab
    1k (the JAX package's reduced_decoder, decoder fields only)."""
    n_slots = len(cfg.superblock)
    small = dict(
        n_layers=max(2, n_slots) if n_slots > 1 else 2,
        d_model=256,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2),
        head_dim=64,
        d_ff=512,
        vocab=1024,
        sliding_window=16 if cfg.sliding_window else None,
        param_dtype=torch.float32,
    )
    small.update(over)
    if small["n_layers"] % n_slots != 0:
        small["n_layers"] = n_slots * max(1, small["n_layers"] // n_slots)
    return dataclasses.replace(cfg, **small)
