"""Plain reference of a decoder-only language model with sparse experts
(granite-3.0-3b-a800m as the configuration file states it): pre-norm
blocks of grouped-query causal attention with RoPE and an MoE feed
forward of top-k SwiGLU experts, RMSNorm, tied embeddings; loss = mean
next-token cross entropy + aux weight x the summed load-balance terms.

The MoE follows the configuration's departures: the router in float32,
softmax then the top k (ties to the lower expert), gates renormalised
to sum 1; every expert holds at most capacity_factor x T x k / E
(token, expert) pairs of the T tokens of the batch, filled in
token-major order, and a pair past it is dropped. The load-balance term
of a layer is sum_e (share of tokens that picked e) x (mean probability
of e) x E / k.

float32 throughout (TF32 off), or the control's precision
(common.Prec). Layers are recomputed in the backward pass and attention
runs one block of query rows at a time, so that a batch of 4 x 4096
tokens fits beside nothing else on one card. Parameters are a flat
{path: tensor} dict with the program's paths, layers stacked on a
leading axis.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from bench.reference.common import FP32, Prec, log_softmax_pick, rmsnorm


@dataclasses.dataclass(frozen=True)
class Cfg:
    d: int
    layers: int
    heads: int
    kv_heads: int
    ff: int
    experts: int
    top_k: int
    vocab: int
    eps: float
    theta: float
    init: float
    capacity_factor: float
    aux_weight: float
    q_block: int = 1024


def cfg_of(conf: dict) -> Cfg:
    return Cfg(d=conf["hidden_size"], layers=conf["num_hidden_layers"],
               heads=conf["num_attention_heads"],
               kv_heads=conf["num_key_value_heads"],
               ff=conf["intermediate_size"],
               experts=conf["num_local_experts"],
               top_k=conf["num_experts_per_tok"], vocab=conf["vocab_size"],
               eps=conf["rms_norm_eps"], theta=float(conf["rope_theta"]),
               init=conf["initializer_range"],
               capacity_factor=conf["capacity_factor"],
               aux_weight=conf["router_aux_loss_coef"])


def param_layout(c: Cfg) -> List[Tuple[str, tuple, str]]:
    d, L, E, f = c.d, c.layers, c.experts, c.ff
    hd = d // c.heads
    s = "slot0"
    return [("embed/embedding", (c.vocab, d), "normal"),
            ("final_norm/scale", (d,), "zeros"),
            (f"{s}/pre_mixer_norm/scale", (L, d), "zeros"),
            (f"{s}/pre_ffn_norm/scale", (L, d), "zeros"),
            (f"{s}/mixer/wq/kernel", (L, d, c.heads * hd), "normal"),
            (f"{s}/mixer/wk/kernel", (L, d, c.kv_heads * hd), "normal"),
            (f"{s}/mixer/wv/kernel", (L, d, c.kv_heads * hd), "normal"),
            (f"{s}/mixer/wo/kernel", (L, c.heads * hd, d), "normal"),
            (f"{s}/ffn/router/kernel", (L, d, E), "normal"),
            (f"{s}/ffn/up", (L, E, d, f), "normal"),
            (f"{s}/ffn/gate", (L, E, d, f), "normal"),
            (f"{s}/ffn/down", (L, E, f, d), "normal")]


def _rope(x, theta):
    """Split-half rotary embedding of x (B, S, H, hd) at positions 0..S-1."""
    S, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend_block(q, k, v, start, prec: Prec):
    """Causal attention of the query rows start.. (q: (B, H, qb, hd)) over
    all keys (B, H, S, hd)."""
    qb, S = q.shape[2], k.shape[2]
    logits = prec.mm(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    rows = torch.arange(start, start + qb, device=q.device)[:, None]
    cols = torch.arange(S, device=q.device)[None, :]
    logits = logits.masked_fill(cols > rows, float("-inf"))
    return prec.mm(torch.softmax(logits, dim=-1), v)


def _attention(p, i, c: Cfg, h, prec: Prec):
    B, S, d = h.shape
    hd = d // c.heads
    a = lambda n: p[f"slot0/mixer/{n}/kernel"][i]
    q = _rope(prec.mm(h, a("wq")).reshape(B, S, c.heads, hd), c.theta)
    k = _rope(prec.mm(h, a("wk")).reshape(B, S, c.kv_heads, hd), c.theta)
    v = prec.mm(h, a("wv")).reshape(B, S, c.kv_heads, hd)
    rep = c.heads // c.kv_heads
    q = q.transpose(1, 2)
    k = k.repeat_interleave(rep, dim=2).transpose(1, 2)
    v = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    qb = min(c.q_block, S)
    outs = [checkpoint(_attend_block, q[:, :, s:s + qb], k, v, s, prec,
                       use_reentrant=False) for s in range(0, S, qb)]
    o = torch.cat(outs, dim=2).transpose(1, 2).reshape(B, S, c.heads * hd)
    return prec.mm(o, a("wo"))


def _moe(p, i, c: Cfg, h, prec: Prec):
    """(output (B, S, d), load-balance term) of layer i's experts."""
    B, S, d = h.shape
    E, K = c.experts, c.top_k
    T = B * S
    x = h.reshape(T, d)
    probs = torch.softmax(x @ p["slot0/ffn/router/kernel"][i], dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = vals[:, :K], idx[:, :K]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    cap = max(1, int(c.capacity_factor * T * K / E))
    flat_e = experts.reshape(-1)                          # token-major
    onehot = torch.nn.functional.one_hot(flat_e, E)
    pos = (torch.cumsum(onehot, dim=0) - 1).gather(1, flat_e[:, None])[:, 0]
    keep = pos < cap
    token = torch.arange(T, device=h.device).repeat_interleave(K)
    w = gates.reshape(-1)
    out = torch.zeros_like(x)
    for e in range(E):
        sel = torch.nonzero((flat_e == e) & keep)[:, 0]
        rows = x[token[sel]]
        up = prec.mm(rows, p["slot0/ffn/up"][i, e])
        gate = prec.mm(rows, p["slot0/ffn/gate"][i, e])
        y = prec.mm(torch.nn.functional.silu(gate) * up,
                    p["slot0/ffn/down"][i, e])
        out = out.index_add(0, token[sel], y * w[sel, None])
    picked = onehot.reshape(T, K, E).sum(1) > 0
    aux = (picked.float().mean(0) * probs.mean(0)).sum() * (E / K)
    return out.reshape(B, S, d), aux


def _layer(p, i, c: Cfg, x, prec: Prec):
    x = x + _attention(p, i, c, rmsnorm(
        x, p["slot0/pre_mixer_norm/scale"][i], c.eps), prec)
    y, aux = _moe(p, i, c, rmsnorm(x, p["slot0/pre_ffn_norm/scale"][i],
                                   c.eps), prec)
    return x + y, aux


def _nll_block(p, c: Cfg, x, labels, prec: Prec):
    h = rmsnorm(x, p["final_norm/scale"], c.eps)
    logits = prec.mm(h, p["embed/embedding"].t())
    return -log_softmax_pick(logits, labels).sum()


def loss_fn(p: Dict[str, torch.Tensor], c: Cfg, mb, prec: Prec = FP32,
            block: int = 1024):
    """The microbatch's loss: mean next-token cross entropy over its
    labels (none ignored) + aux_weight x the layers' summed load-balance
    terms; the readout runs `block` positions at a time, recomputed in
    the backward pass."""
    tokens, labels = mb["tokens"].long(), mb["labels"].long()
    x = p["embed/embedding"][tokens]
    aux = 0.0
    for i in range(c.layers):
        x, a = checkpoint(_layer, p, i, c, x, prec, use_reentrant=False)
        aux = aux + a
    B, S = labels.shape
    nll = sum(checkpoint(_nll_block, p, c, x[:, s:s + block],
                         labels[:, s:s + block], prec, use_reentrant=False)
              for s in range(0, S, block))
    return nll / (B * S) + c.aux_weight * aux


def loss_and_grads(p: Dict[str, torch.Tensor], c: Cfg, mb, prec: Prec = FP32):
    """(loss, {path: grad}) of one microbatch; the whole microbatch is one
    routing group, so it runs at once."""
    live = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    loss = loss_fn(live, c, mb, prec)
    gs = torch.autograd.grad(loss, list(live.values()))
    return float(loss.detach()), dict(zip(live, gs))
