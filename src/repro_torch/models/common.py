"""Functional building blocks over dicts of tensors (port of
repro/models/common.py).

Params are nested dicts of tensors with the JAX package's keys and
layouts: dense kernels are stored (in, out), embeddings (vocab, dim),
RMSNorm scales in the gemma (1 + scale) form, LayerNorm as scale and
bias. Models keep params in
`param_dtype` and cast to `compute_dtype` at use.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

# The batch key under which a block of a larger batch (one rank's, in a
# train step on a mesh: distributed/steps.py) carries that whole batch.
# A loss that is a mean takes it over the whole batch's count, so that
# the blocks' losses, and their gradients, add up to the whole batch's.
WHOLE = "whole"

def _randn(gen: Optional[torch.Generator], shape):
    """Standard normal draw from `gen` on its device; gen=None draws on
    the ambient default device (e.g. under `torch.device("meta")`, which
    gives the shapes of an init without its memory)."""
    return torch.randn(shape, generator=gen,
                       device=None if gen is None else gen.device)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, *,
               use_bias: bool = False, dtype=torch.float32,
               scale: Optional[float] = None, lead: tuple = ()):
    """`lead` prepends stacking dims (the decoder stacks each slot's
    params over its periods, as the JAX package's vmapped init does)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = _randn(gen, (*lead, in_dim, out_dim))
    p = {"kernel": (w * scale).to(dtype)}
    if use_bias:
        p["bias"] = torch.zeros((*lead, out_dim), dtype=dtype,
                                device=w.device)
    return p


def dense_apply(p, x, compute_dtype=torch.bfloat16):
    y = torch.matmul(x.to(compute_dtype), p["kernel"].to(compute_dtype))
    if "bias" in p:
        y = y + p["bias"].to(compute_dtype)
    return y


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype=torch.float32):
    e = _randn(gen, (vocab, dim))
    return {"embedding": (e * 0.02).to(dtype)}


def embed_apply(p, ids, compute_dtype=torch.bfloat16):
    return p["embedding"][ids.long()].to(compute_dtype)


def embed_attend(p, x, compute_dtype=torch.bfloat16):
    """Tied-readout logits: x @ E^T."""
    return torch.matmul(x.to(compute_dtype),
                        p["embedding"].to(compute_dtype).t())


def rmsnorm_init(dim: int, dtype=torch.float32, device=None,
                 lead: tuple = ()):
    return {"scale": torch.zeros((*lead, dim), dtype=dtype, device=device)}


def rmsnorm_apply(p, x, eps: float = 1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + p["scale"].float())).to(x.dtype)


def layernorm_init(dim: int, dtype=torch.float32, device=None,
                   lead: tuple = ()):
    return {"scale": torch.ones((*lead, dim), dtype=dtype, device=device),
            "bias": torch.zeros((*lead, dim), dtype=dtype, device=device)}


def layernorm_apply(p, x, eps: float = 1e-6):
    """LayerNorm with fp32 statistics, returned in x's dtype."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    xc = x32 - mu
    var = torch.mean(xc * xc, dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def softcap(x, cap: Optional[float]):
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


def rope_freqs(head_dim: int, theta: float = 10000.0, device="cpu"):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 10000.0):
    """Split-half RoPE. x: (..., seq, heads, head_dim); positions
    broadcastable to (..., seq)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def unbind_layers(tree):
    """Per-layer views of a param subtree stacked on a leading layer (or
    period) axis: for each leaf, the tuple of its slices. One unbind per
    leaf, so the backward pass stacks the layers' gradients once
    (indexing layer by layer would build and add a full-size gradient
    per layer instead)."""
    return {k: unbind_layers(v) if isinstance(v, dict) else v.unbind(0)
            for k, v in tree.items()}


def layer_params(tree, i: int):
    """Layer (or period) i of a tree unbound by unbind_layers."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def gelu(x):
    return F.gelu(x, approximate="tanh")


def silu(x):
    return F.silu(x)


ACTIVATIONS = {"gelu": gelu, "silu": silu, "relu": torch.relu}


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, *,
             gated: bool = True, use_bias: bool = False,
             dtype=torch.float32, lead: tuple = ()):
    kw = dict(use_bias=use_bias, dtype=dtype, lead=lead)
    p = {"up": dense_init(gen, d_model, d_ff, **kw),
         "down": dense_init(gen, d_ff, d_model, **kw)}
    if gated:
        p["gate"] = dense_init(gen, d_model, d_ff, **kw)
    return p


def mlp_apply(p, x, *, activation: str = "silu",
              compute_dtype=torch.bfloat16):
    act = ACTIVATIONS[activation]
    up = dense_apply(p["up"], x, compute_dtype)
    if "gate" in p:
        up = act(dense_apply(p["gate"], x, compute_dtype)) * up
    else:
        up = act(up)
    return dense_apply(p["down"], up, compute_dtype)
