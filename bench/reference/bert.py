"""Plain reference of BERT pretraining (arXiv:1810.04805) as the
configuration file states it: post-LN encoder, learned position and
token-type embeddings, GELU (tanh form) MLP, MLM head (transform, GELU,
LayerNorm, tied decoder plus an output bias) scored at every position,
NSP head on the tanh pooler of [CLS]; loss = mean masked-LM cross
entropy over the masked positions + mean NSP cross entropy over the
rows. The departures the configuration lists are followed (no dropout,
eps 1e-6, no bias on the attention output, no key mask).

float32 throughout (TF32 off, common.no_tf32), or the control's
precision (common.Prec). Parameters are a flat {path: tensor} dict with
the program's paths, layers stacked on a leading axis.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import torch

from bench.reference.common import (FP32, Prec, gelu_tanh, layernorm,
                                    log_softmax_pick)


@dataclasses.dataclass(frozen=True)
class Cfg:
    d: int
    layers: int
    heads: int
    ff: int
    vocab: int
    max_pos: int
    type_vocab: int
    eps: float
    init: float


def cfg_of(conf: dict) -> Cfg:
    return Cfg(d=conf["hidden_size"], layers=conf["num_hidden_layers"],
               heads=conf["num_attention_heads"],
               ff=conf["intermediate_size"], vocab=conf["vocab_size"],
               max_pos=conf["max_position_embeddings"],
               type_vocab=conf["type_vocab_size"],
               eps=conf["layer_norm_eps"], init=conf["initializer_range"])


def param_layout(c: Cfg) -> List[Tuple[str, tuple, str]]:
    """(path, shape, init) of every leaf, init "normal" (N(0, init^2)),
    "zeros" or "ones"."""
    d, L, f, V = c.d, c.layers, c.ff, c.vocab
    out = [("tok_embed/embedding", (V, d), "normal"),
           ("pos_embed", (c.max_pos, d), "normal"),
           ("type_embed", (c.type_vocab, d), "normal"),
           ("embed_ln/scale", (d,), "ones"), ("embed_ln/bias", (d,), "zeros")]
    for w in ("wq", "wk", "wv"):
        out += [(f"layers/attn/{w}/kernel", (L, d, d), "normal"),
                (f"layers/attn/{w}/bias", (L, d), "zeros")]
    out += [("layers/attn/wo/kernel", (L, d, d), "normal"),
            ("layers/attn_ln/scale", (L, d), "ones"),
            ("layers/attn_ln/bias", (L, d), "zeros"),
            ("layers/mlp/up/kernel", (L, d, f), "normal"),
            ("layers/mlp/up/bias", (L, f), "zeros"),
            ("layers/mlp/down/kernel", (L, f, d), "normal"),
            ("layers/mlp/down/bias", (L, d), "zeros"),
            ("layers/mlp_ln/scale", (L, d), "ones"),
            ("layers/mlp_ln/bias", (L, d), "zeros"),
            ("mlm_transform/kernel", (d, d), "normal"),
            ("mlm_transform/bias", (d,), "zeros"),
            ("mlm_ln/scale", (d,), "ones"), ("mlm_ln/bias", (d,), "zeros"),
            ("mlm_bias", (V,), "zeros"),
            ("pooler/kernel", (d, d), "normal"),
            ("pooler/bias", (d,), "zeros"),
            ("nsp_head/kernel", (d, 2), "normal"),
            ("nsp_head/bias", (2,), "zeros")]
    return out


def _layer(p, i, c: Cfg, x, prec: Prec):
    B, S, d = x.shape
    hd = d // c.heads
    a = lambda n: p[f"layers/attn/{n}"][i]
    split = lambda t: t.reshape(B, S, c.heads, hd).transpose(1, 2)
    q = split(prec.dense(x, a("wq/kernel"), a("wq/bias")))
    k = split(prec.dense(x, a("wk/kernel"), a("wk/bias")))
    v = split(prec.dense(x, a("wv/kernel"), a("wv/bias")))
    probs = torch.softmax(prec.mm(q, k.transpose(-1, -2)) / math.sqrt(hd),
                          dim=-1)
    o = prec.mm(probs, v).transpose(1, 2).reshape(B, S, d)
    h = prec.mm(o, a("wo/kernel"))
    ln = lambda n, t: layernorm(t, p[f"layers/{n}/scale"][i],
                                p[f"layers/{n}/bias"][i], c.eps)
    x = ln("attn_ln", x + h)
    m = lambda n: p[f"layers/mlp/{n}"][i]
    h = gelu_tanh(prec.dense(x, m("up/kernel"), m("up/bias")))
    h = prec.dense(h, m("down/kernel"), m("down/bias"))
    return ln("mlp_ln", x + h)


def sums(p: Dict[str, torch.Tensor], c: Cfg, rows, prec: Prec = FP32):
    """(sum of masked-LM -log p over the masked positions, sum of NSP
    -log p over the rows) of a block of rows."""
    tokens = rows["tokens"].long()
    S = tokens.shape[1]
    x = (p["tok_embed/embedding"][tokens] + p["pos_embed"][:S][None]
         + p["type_embed"][rows["token_types"].long()])
    x = layernorm(x, p["embed_ln/scale"], p["embed_ln/bias"], c.eps)
    for i in range(c.layers):
        x = _layer(p, i, c, x, prec)
    t = gelu_tanh(prec.dense(x, p["mlm_transform/kernel"],
                             p["mlm_transform/bias"]))
    t = layernorm(t, p["mlm_ln/scale"], p["mlm_ln/bias"], c.eps)
    logits = prec.mm(t, p["tok_embed/embedding"].t()) + p["mlm_bias"]
    labels = rows["mlm_labels"].long()
    valid = labels != -100
    ll = log_softmax_pick(logits, torch.where(valid, labels, 0))
    mlm = -(ll * valid).sum()
    cls = torch.tanh(prec.dense(x[:, 0], p["pooler/kernel"],
                                p["pooler/bias"]))
    nsp = prec.dense(cls, p["nsp_head/kernel"], p["nsp_head/bias"])
    nsp_ll = log_softmax_pick(nsp, rows["nsp_labels"].long())
    return mlm, -nsp_ll.sum()


def loss_and_grads(p: Dict[str, torch.Tensor], c: Cfg, mb, prec: Prec = FP32,
                   block: int = 16):
    """(loss, {path: grad}) of one microbatch `mb` (torch tensors on the
    device): mean MLM loss over its masked positions + mean NSP loss over
    its rows, the gradient summed over blocks of `block` rows."""
    n_rows = mb["tokens"].shape[0]
    n_masked = max(int((mb["mlm_labels"] != -100).sum()), 1)
    live = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    grads = {k: torch.zeros_like(v) for k, v in p.items()}
    total = 0.0
    for r in range(0, n_rows, block):
        rows = {k: v[r:r + block] for k, v in mb.items()}
        mlm, nsp = sums(live, c, rows, prec)
        loss = mlm / n_masked + nsp / n_rows
        gs = torch.autograd.grad(loss, list(live.values()), allow_unused=True)
        for k, g in zip(live, gs):
            if g is not None:
                grads[k] += g
        total += float(loss.detach())
    return total, grads
