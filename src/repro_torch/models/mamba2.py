"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) block (port of
repro/models/mamba2.py).

Chunked SSD: the sequence is split into chunks of `chunk` steps; within a
chunk the recurrence runs in its quadratic "attention-like" dual form
(matrix products), and a loop over the chunks carries the (heads,
dstate, headdim) state, where the JAX package scans. A decode step (S ==
1 with a cache) takes the recurrent path: O(1) per token.

Layer anatomy (as in the JAX package):
  in_proj -> [z (gate), x, B, C, dt]; causal depthwise conv over (x, B, C);
  dt = softplus(dt + dt_bias); a_t = exp(dt * -exp(A_log));
  h_t = a_t h_{t-1} + dt_t * (B_t ⊗ x_t); y_t = C_t · h_t + D * x_t;
  out = out_proj(RMSNorm(y * silu(z))).

Left padding (`valid` False) cannot leak into the state: its conv inputs
are zeroed (the zero history a pad-free run sees) and its dt is forced
to 0, which makes the SSM update an exact identity. Outputs at padding
are garbage and masked downstream.

The cache {"ssm" (B, H, N, P), "conv" (B, W - 1, C)} is fp32 (also when
the KV arenas are bf16) and, as the port's attention caches, is written
IN PLACE: the chunked path starts from its state and leaves the final
state and the conv tail in it, which is what a chunked prefill carries
from chunk to chunk.

On a mesh whose model axis cuts the mixer on whole heads (a train step:
distributed/sharding.py: use_plan, kind "mamba"), each rank runs the
mixer on its H / m heads (`_mamba_split`): its in_proj columns arrive
exchanged into its heads' z, x and dt and the whole B and C (or its
groups, where they divide), its conv_w likewise, in_proj's input
gradient summed over "model" (Megatron's f); dt_bias, A_log, D and the
norm scale are sliced to its heads (model_slice), the conv bias taken at
its channels (model_take). The SSD scan needs nothing of the other
heads. The gated RMSNorm over the whole d_inner sums its squares over
"model" in rank order (all_sum), and out_proj is row parallel.
Serving on such a mesh runs the same split with a cache: the rank's
in_proj and conv_w arrive already in its columns (placed at load:
distributed/sharding.py: serve_params), and its cache holds its heads'
SSM state (B, H / m, N, P) and its channels' conv tail (init_mamba_cache
of local_cfg), which the recurrent step and the chunked scan from a
state (prefill, chunked prefill) update in place.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import (ambient, dense_apply, dense_init,
                                       rmsnorm_apply, rmsnorm_init, tp_kind)


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_model: int
    d_inner: int          # typically 2 * d_model
    headdim: int = 64
    dstate: int = 128
    ngroups: int = 1
    conv_width: int = 4
    chunk: int = 64

    @property
    def nheads(self) -> int:
        if self.d_inner % self.headdim:
            raise ValueError(f"d_inner {self.d_inner} is not a multiple of "
                             f"headdim {self.headdim}")
        return self.d_inner // self.headdim

    @property
    def conv_channels(self) -> int:
        return self.d_inner + 2 * self.ngroups * self.dstate


def mamba_init(gen: torch.Generator, cfg: MambaConfig, dtype=torch.float32,
               lead: tuple = ()):
    """The JAX package's init; `lead` prepends stacking dims."""
    dev = None if gen is None else gen.device
    d_in_proj = 2 * cfg.d_inner + 2 * cfg.ngroups * cfg.dstate + cfg.nheads
    c, h = cfg.conv_channels, cfg.nheads
    a_log = torch.log(torch.arange(1, h + 1, dtype=torch.float32,
                                   device=dev))
    return {
        "in_proj": dense_init(gen, cfg.d_model, d_in_proj, dtype=dtype,
                              lead=lead),
        "conv_w": (torch.randn((*lead, cfg.conv_width, c), generator=gen,
                               device=dev) * 0.1).to(dtype),
        "conv_b": torch.zeros((*lead, c), dtype=dtype, device=dev),
        "A_log": a_log.expand(*lead, h).to(dtype).clone(),
        "dt_bias": torch.zeros((*lead, h), dtype=dtype, device=dev),
        "D": torch.ones((*lead, h), dtype=dtype, device=dev),
        "norm": rmsnorm_init(cfg.d_inner, dtype, dev, lead),
        "out_proj": dense_init(gen, cfg.d_inner, cfg.d_model, dtype=dtype,
                               lead=lead),
    }


def _causal_conv(x, w, b, conv_state=None):
    """Depthwise causal conv, x (B, S, C), w (W, C) -> (silu(y), the last
    W - 1 inputs). conv_state (B, W - 1, C): the inputs before x."""
    W = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                 # (B, S + W - 1, C)
    S = x.shape[1]
    y = 0
    for i in range(W):                              # the reference's order
        y = y + xp[:, i:i + S, :] * w[i][None, None, :]
    y = F.silu(y + b[None, None, :])
    return y, xp[:, -(W - 1):, :]


def _ssd_chunked(xh, dt, a_log_t, Bm, Cm, cfg: MambaConfig, h0=None):
    """Chunked SSD. xh (B, S, H, P); dt, a_log_t (B, S, H) (step sizes
    and log decays dt * A); Bm, Cm (B, S, G, N); h0 (B, H, N, P) or None.
    Returns (y (B, S, H, P), final state)."""
    B, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    L = cfg.chunk
    if S % L:
        raise ValueError(f"sequence {S} is not a multiple of the SSD "
                         f"chunk {L}")
    nc = S // L
    rep = H // G

    xc = xh.reshape(B, nc, L, H, P)
    dtc = dt.reshape(B, nc, L, H)
    alc = a_log_t.reshape(B, nc, L, H)
    Bc = Bm.reshape(B, nc, L, G, N)
    Cc = Cm.reshape(B, nc, L, G, N)

    cum = torch.cumsum(alc, dim=2)                       # (B, nc, L, H)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, nc, t, s, H)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=xh.device))
    # mask BEFORE exp: masked (t < s) entries have seg > 0 and can
    # overflow to inf; exp-then-where would leak NaN into the backward
    # pass (0 * inf)
    seg = torch.where(causal[None, None, :, :, None], seg,
                      torch.tensor(-math.inf, device=xh.device))
    decay = torch.exp(seg)

    Bg = Bc.repeat_interleave(rep, dim=3)                # (B, nc, L, H, N)
    Cg = Cc.repeat_interleave(rep, dim=3)

    scores = (torch.einsum("bclhn,bcshn->bclsh", Cg, Bg) * decay
              * dtc[:, :, None, :, :])
    y_intra = torch.einsum("bclsh,bcshp->bclhp", scores, xc)

    chunk_decay = torch.exp(cum[:, :, -1:, :] - cum)     # exp(sum after s)
    states = torch.einsum("bclh,bclhn,bclhp->bchnp", chunk_decay * dtc, Bg,
                          xc)                            # (B, nc, H, N, P)
    total_decay = torch.exp(cum[:, :, -1, :])            # (B, nc, H)

    h = (torch.zeros((B, H, N, P), dtype=xh.dtype, device=xh.device)
         if h0 is None else h0.to(xh.dtype))
    h_prevs = []
    for c in range(nc):            # the pre-chunk state feeds chunk c
        h_prevs.append(h)
        h = h * total_decay[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                # (B, nc, H, N, P)

    in_decay = torch.exp(cum)
    y_inter = torch.einsum("bclhn,bchnp->bclhp", Cg * in_decay[..., None],
                           h_prevs)
    return (y_intra + y_inter).reshape(B, S, H, P), h


def mamba_apply(p, cfg: MambaConfig, x, *, cache=None, valid=None,
                compute_dtype=torch.bfloat16):
    """x (B, S, d_model) -> (out in x's dtype, cache or None). cache:
    {"ssm", "conv"} (and the decoder's "index"), updated in place; S == 1
    with a cache is the recurrent step, anything else the chunked scan
    (from the cache's state when given). valid: optional (B, S) bool,
    False at left padding."""
    if tp_kind(p["in_proj"]["kernel"]) == "mamba":
        return _mamba_split(p, cfg, x, valid, compute_dtype, cache)
    proj = dense_apply(p["in_proj"], x, compute_dtype)
    y, new_cache = _ssm(cfg, proj, p["conv_w"], p["conv_b"], p["dt_bias"],
                        p["A_log"], p["D"], compute_dtype, valid, cache)
    y = rmsnorm_apply(p["norm"], y)
    out = dense_apply(p["out_proj"], y, compute_dtype)
    return out.to(x.dtype), new_cache


def _ssm(cfg: MambaConfig, proj, conv_w, conv_b, dt_bias, a_log, d_skip,
         compute_dtype, valid=None, cache=None):
    """The mixer between its projections: proj (B, S, in_proj's columns)
    -> (y * silu(z) (B, S, d_inner) in compute_dtype, cache or None)."""
    B, S, _ = proj.shape
    H, P, G, N = cfg.nheads, cfg.headdim, cfg.ngroups, cfg.dstate
    di = cfg.d_inner

    z, xr, Bm, Cm, dt = torch.split(
        proj, [di, di, G * N, G * N, H], dim=-1)

    conv_in = torch.cat([xr, Bm, Cm], dim=-1)
    if valid is not None:
        conv_in = conv_in * valid[..., None].to(conv_in.dtype)
    conv_state = cache["conv"] if cache is not None else None
    conv_out, new_conv = _causal_conv(
        conv_in, conv_w.to(compute_dtype), conv_b.to(compute_dtype),
        conv_state)
    xr, Bm, Cm = torch.split(conv_out, [di, G * N, G * N], dim=-1)

    dt = F.softplus(dt.float() + dt_bias.float())
    if valid is not None:
        dt = dt * valid[..., None].to(dt.dtype)
    A = -torch.exp(a_log.float())                        # (H,) negative
    a_log_t = dt * A[None, None, :]                      # (B, S, H)

    xh = xr.reshape(B, S, H, P)
    Bm = Bm.reshape(B, S, G, N)
    Cm = Cm.reshape(B, S, G, N)

    if cache is not None and S == 1:
        # recurrent step: h = a h + dt (B ⊗ x); y = C · h
        h = cache["ssm"].float()                         # (B, H, N, P)
        a = torch.exp(a_log_t[:, 0, :])                  # (B, H)
        Bg = Bm[:, 0].repeat_interleave(H // G, dim=1)   # (B, H, N)
        Cg = Cm[:, 0].repeat_interleave(H // G, dim=1)
        xt = xh[:, 0].float()                            # (B, H, P)
        h_new = (h * a[..., None, None]
                 + dt[:, 0, :, None, None] * Bg.float()[..., None]
                 * xt[:, :, None, :])
        y = torch.einsum("bhn,bhnp->bhp", Cg.float(), h_new)
        y = y[:, None].to(compute_dtype)                 # (B, 1, H, P)
    else:
        h0 = cache["ssm"] if cache is not None else None
        y, h_new = _ssd_chunked(xh.float(), dt, a_log_t, Bm.float(),
                                Cm.float(), cfg, h0)
        y = y.to(compute_dtype)
    new_cache = None
    if cache is not None:
        cache["ssm"].copy_(h_new)
        cache["conv"].copy_(new_conv)
        new_cache = {"ssm": cache["ssm"], "conv": cache["conv"]}
        if "index" in cache:
            new_cache["index"] = cache["index"] + S

    y = y + d_skip.to(compute_dtype)[None, None, :, None] * xh
    y = y.reshape(B, S, di)
    return y * F.silu(z), new_cache


def local_cfg(cfg: MambaConfig, model: int) -> MambaConfig:
    """The mixer one of `model` ranks runs: its heads, and its groups
    where they divide (else all of them, B and C whole on every rank)."""
    groups = cfg.ngroups // model if cfg.ngroups % model == 0 else \
        cfg.ngroups
    return dataclasses.replace(cfg, d_inner=cfg.d_inner // model,
                               ngroups=groups)


def sum_sq(y):
    """fp32 sum of squares over y's last dim (keepdim): a rank's part of
    the gated norm's over the whole d_inner."""
    y32 = y.float()
    return (y32 * y32).sum(-1, keepdim=True)


def gated_norm(y, ss, n: int, scale, eps: float = 1e-6):
    """rmsnorm_apply of y, whose sum of squares over all `n` columns
    (this rank's and the others') is `ss`, with the scale of y's
    columns."""
    y32 = y.float()
    out = y32 * torch.rsqrt(ss / n + eps)
    return (out * (1.0 + scale.float())).to(y.dtype)


def _mamba_split(p, cfg: MambaConfig, x, valid, compute_dtype, cache=None):
    """The mixer on this rank's heads of a model axis that cuts it (the
    module docstring) -> (its output summed over "model", cache or
    None). cache: the rank's share of a serving cache (init_mamba_cache
    of local_cfg: its heads' SSM state, its channels' conv tail), which
    the recurrent step or the chunked scan from its state updates in
    place, as on one device."""
    import torch.distributed as dist
    from repro_torch.distributed import partial
    from repro_torch.distributed.sharding import (mamba_segments,
                                                  segment_columns)
    group = ambient().group("model")
    model, rank = dist.get_world_size(group), dist.get_rank(group)
    lc = local_cfg(cfg, model)
    proj = dense_apply(p["in_proj"], x, compute_dtype)
    channels = segment_columns(mamba_segments("conv_w", cfg, model), model,
                               rank)
    conv_b = partial.model_take(p["conv_b"], channels, group)
    heads = [partial.model_slice(p[k], 0, group)
             for k in ("dt_bias", "A_log", "D")]
    y, new_cache = _ssm(lc, proj, p["conv_w"], conv_b, *heads,
                        compute_dtype, valid, cache)
    ss = partial.all_sum(sum_sq(y), group)
    y = gated_norm(y, ss, cfg.d_inner,
                   partial.model_slice(p["norm"]["scale"], 0, group))
    return (dense_apply(p["out_proj"], y, compute_dtype).to(x.dtype),
            new_cache)


def init_mamba_cache(batch: int, cfg: MambaConfig, dtype=torch.float32,
                     device="cpu", lead: tuple = ()):
    """Zero SSM state and conv tail of `batch` slots, fp32 by default;
    `lead` prepends stacking dims (the decoder's periods). A serving
    mesh's rank passes its local_cfg: its heads' state and its conv
    channels."""
    return {
        "ssm": torch.zeros((*lead, batch, cfg.nheads, cfg.dstate,
                            cfg.headdim), dtype=dtype, device=device),
        "conv": torch.zeros((*lead, batch, cfg.conv_width - 1,
                             cfg.conv_channels), dtype=dtype, device=device),
    }
