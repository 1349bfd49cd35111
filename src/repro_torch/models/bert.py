"""BERT, the paper's own pretraining workload (port of
repro/models/bert.py).

Post-LN encoder, learned positional + token-type embeddings, GELU MLP with
biases, MLM head (transform -> tied decoder + fp32 output bias) and NSP
head over the [CLS] pooler. The pretraining loss is MLM cross-entropy +
NSP cross-entropy, what LANS optimizes.

As in the JAX package, the layer params are stacked on a leading
n_layers axis (one LANS block spans all layers) and each layer is
rematerialized in the backward pass (torch.utils.checkpoint, where JAX
remats its scanned layer). On a mesh a layer's leaves are fetched
inside its recomputed region (models/common.py: layer_params), the
other leaves at their use, the tied token embedding once for both of
its uses. `compute_dtype` defaults to
bf16 (`bert.py:41`), so an fp32-policy run still does its matmuls in bf16
(ROADMAP Queue 3); parity tests set it to fp32.

Serving (`bert_serve_outputs`, the engine's score/embed step): one
cache-free forward over left-padded rows whose pad columns carry
position < 0 and are masked as keys, returning greedy masked-LM ids and
the tanh-pooled vector at each row's first valid column.

bert_large: 24L / 1024d / 16H / ff 4096 / vocab 30522 / max_pos 512.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.metrics.spans import span
from repro_torch.models.attention import AttnConfig, attn_apply, attn_init
from repro_torch.models.common import (_randn, ambient, dense_apply,
                                       dense_init, embed_apply, embed_attend,
                                       embed_init, fetch, fetch_tree, gelu,
                                       is_vocab, layer_params,
                                       layernorm_apply, layernorm_init,
                                       log_likelihood, mlp_apply, mlp_init,
                                       unbind_layers, WHOLE)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    name: str = "bert_large"
    n_layers: int = 24
    d_model: int = 1024
    n_heads: int = 16
    d_ff: int = 4096
    vocab: int = 30522
    max_pos: int = 512
    type_vocab: int = 2
    compute_dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def attn_cfg(self) -> AttnConfig:
        return AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_heads, head_dim=self.head_dim,
            qkv_bias=True, rope=False, causal=False)


def bert_init(gen: Optional[torch.Generator], cfg: BertConfig):
    """Random params drawn from `gen` on its device (gen=None: the ambient
    device, e.g. `torch.device("meta")` for shapes only)."""
    dt, L = cfg.param_dtype, (cfg.n_layers,)
    dev = None if gen is None else gen.device
    ln = lambda lead=(): layernorm_init(cfg.d_model, dt, dev, lead)
    return {
        "tok_embed": embed_init(gen, cfg.vocab, cfg.d_model, dt),
        "pos_embed": (_randn(gen, (cfg.max_pos, cfg.d_model)) * 0.02).to(dt),
        "type_embed": (_randn(gen, (cfg.type_vocab, cfg.d_model))
                       * 0.02).to(dt),
        "embed_ln": ln(),
        "layers": {
            "attn": attn_init(gen, cfg.attn_cfg(), dtype=dt, lead=L),
            "attn_ln": ln(L),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, gated=False,
                            use_bias=True, dtype=dt, lead=L),
            "mlp_ln": ln(L),
        },
        "mlm_transform": dense_init(gen, cfg.d_model, cfg.d_model,
                                    use_bias=True, dtype=dt),
        "mlm_ln": ln(),
        "mlm_bias": torch.zeros((cfg.vocab,), dtype=dt, device=dev),
        "pooler": dense_init(gen, cfg.d_model, cfg.d_model, use_bias=True,
                             dtype=dt),
        "nsp_head": dense_init(gen, cfg.d_model, 2, use_bias=True, dtype=dt),
    }


def _layer(cfg: BertConfig, x, layers, i, positions):
    cd = cfg.compute_dtype
    lp = layer_params(layers, i)
    h, _ = attn_apply(lp["attn"], cfg.attn_cfg(), x, positions=positions,
                      compute_dtype=cd)
    x = layernorm_apply(lp["attn_ln"], x + h)
    h = mlp_apply(lp["mlp"], x, activation="gelu", compute_dtype=cd)
    return layernorm_apply(lp["mlp_ln"], x + h)


def bert_encode(params, cfg: BertConfig, tokens, token_types=None,
                positions=None):
    """tokens (B, S) -> hidden states (B, S, d) in compute_dtype. Post-LN
    residual stack; every layer is recomputed in the backward pass
    instead of keeping its activations.

    positions (B, S) gives each token its LOCAL position (left-padded
    serving rows: pads carry pos < 0): the position embedding is looked
    up per token (clipped into the table) and pad columns are masked out
    of the bidirectional attention as keys. None keeps the training
    path's 0..S-1."""
    cd = cfg.compute_dtype
    S = tokens.shape[1]
    x = embed_apply(fetch_tree(params["tok_embed"]), tokens, cd)
    pos_embed = fetch(params["pos_embed"])
    if positions is None:
        x = x + pos_embed.to(cd)[None, :S]
    else:
        x = x + pos_embed.to(cd)[
            torch.clamp(positions, 0, cfg.max_pos - 1).long()]
    del pos_embed
    if token_types is None:
        token_types = torch.zeros_like(tokens)
    x = x + fetch(params["type_embed"]).to(cd)[token_types.long()]
    x = layernorm_apply(fetch_tree(params["embed_ln"]), x)
    layers = unbind_layers(params["layers"])
    for i in range(cfg.n_layers):
        if torch.is_grad_enabled():
            x = checkpoint(_layer, cfg, x, layers, i, positions,
                           use_reentrant=False)
        else:
            x = _layer(cfg, x, layers, i, positions)
    return x


def _mlm_logits(params, cfg: BertConfig, h):
    """The MLM head: transform, tied decoder, fp32 output bias (on a mesh
    whose model axis cuts the vocab, the rank's columns and its slice of
    the bias: models/common.py: embed_attend)."""
    cd = cfg.compute_dtype
    t = dense_apply(fetch_tree(params["mlm_transform"]), h, cd)
    t = layernorm_apply(fetch_tree(params["mlm_ln"]), gelu(t))
    return embed_attend(fetch_tree(params["tok_embed"]), t, cd,
                        bias=fetch(params["mlm_bias"]))


def _tied(params):
    """params with the token embedding fetched once, for the lookup and
    the MLM head both (one gather, and one sum of its gradient)."""
    return {**params, "tok_embed": fetch_tree(params["tok_embed"])}


def bert_pretrain_logits(params, cfg: BertConfig, tokens, token_types=None):
    """Returns (mlm_logits (B, S, V) fp32, nsp_logits (B, 2) fp32)."""
    cd = cfg.compute_dtype
    params = _tied(params)
    h = bert_encode(params, cfg, tokens, token_types)
    with span("model.head"):
        mlm = _mlm_logits(params, cfg, h)
        cls = torch.tanh(dense_apply(fetch_tree(params["pooler"]), h[:, 0],
                                     cd))
        nsp = dense_apply(fetch_tree(params["nsp_head"]), cls, cd).float()
    return mlm, nsp


def bert_serve_outputs(params, cfg: BertConfig, tokens, positions):
    """Scoring/embedding forward of the serving engine.

    tokens/positions (B, S) LEFT-padded (pads carry pos < 0, as in
    decoder serving prefill). Returns
      mlm_ids (B, S) int32: greedy masked-LM argmax per column (pad
        columns give ids of no meaning; the engine keeps the valid tail),
        the whole vocab's also where a serving mesh cuts it,
      pooled (B, d) fp32: the tanh-pooled vector at each row's FIRST
        valid column (position 0, the [CLS] token).
    One fixed-shape forward, no cache."""
    from repro_torch.serving.sampler import greedy, vocab_cut
    B, S = tokens.shape
    h = bert_encode(params, cfg, tokens, positions=positions)
    with span("model.head"):
        logits = _mlm_logits(params, cfg, h)
        # on a serving mesh whose model axis cuts the vocab: the rank's
        # columns, whose argmax is taken over "model" (serving/sampler.py)
        cut = vocab_cut(ambient().mesh) if is_vocab(logits) else None
        mlm_ids = greedy(logits.reshape(B * S, -1), cut).reshape(B, S)
        # first valid column per row: the first maximum of the indicator
        cls_col = torch.argmax((positions >= 0).to(torch.int32), dim=1)
        cls_h = h[torch.arange(B, device=h.device), cls_col]
        pooled = torch.tanh(dense_apply(params["pooler"], cls_h,
                                        cfg.compute_dtype)).float()
    return mlm_ids, pooled


def bert_pretrain_loss(params, cfg: BertConfig, batch):
    """batch: tokens, token_types, mlm_labels (-100 = unmasked),
    nsp_labels. Returns (loss, {"mlm_loss", "nsp_loss"}). A batch that is
    a block of a larger one carries that one under WHOLE, and the means
    are taken over its masked tokens and rows (models/common.py)."""
    mlm_logits, nsp_logits = bert_pretrain_logits(
        params, cfg, batch["tokens"], batch.get("token_types"))
    with span("model.head"):
        labels = batch["mlm_labels"].long()
        valid = labels != -100
        safe = torch.where(valid, labels, torch.zeros_like(labels))
        ll = log_likelihood(mlm_logits, safe)
        whole = batch.get(WHOLE)
        count = (valid.sum() if whole is None
                 else (whole["mlm_labels"] != -100).sum())
        mlm_loss = -torch.sum(ll * valid) / torch.clamp(count, min=1)
        nsp_logp = F.log_softmax(nsp_logits, dim=-1)
        nsp_ll = torch.gather(nsp_logp, -1,
                              batch["nsp_labels"].long()[:, None])
        nsp_loss = -(torch.mean(nsp_ll) if whole is None
                     else nsp_ll.sum() / whole["nsp_labels"].shape[0])
        return mlm_loss + nsp_loss, {"mlm_loss": mlm_loss,
                                     "nsp_loss": nsp_loss}
