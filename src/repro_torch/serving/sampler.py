"""Token sampling for the serving decode step (port of
repro/serving/sampler.py).

`Sampler.parse` reads the same spec strings as the JAX package.
temperature 0 is greedy argmax (with the optional bf16 tie band of
`stable_argmax`); otherwise the logits are divided by the temperature,
masked to the top-k and then to the top-p set, and one categorical draw
per row picks the token with that row's PRNG key.

The keys and the draw are JAX's, bit for bit: the port carries its own
threefry2x32 so that a sampled stream equals the reference's. As in the
JAX package,

    request key   = fold_in(PRNGKey(sampler.seed), request.rid)
    token-t key   = fold_in(request key, t)

so a stream depends only on (seed, rid, token index). The generator
follows jax 0.9.0's defaults: `jax_threefry_partitionable` on (the
random bits of a shape hash the hi and lo words of each element's flat
index, and 32-bit output is the xor of the two hash words) and the
"low" gumbel mode (`-log(-log(u))`, u uniform in [tiny, 1)). Keys,
bits and uniforms are bit-exact; torch's and XLA's `log` differ by up to
one ulp, so a gumbel value may differ by two ulps at magnitude
max(|g|, 1), and a pick only where two noisy logits tie that closely.

The 32-bit arithmetic runs in int64 with 0xffffffff masks (torch's
uint32 lacks several ops). Keys are (..., 2) uint32 numpy arrays on
the host; the draw runs on the logits' device.

Vocab-parallel picks. On a serving mesh whose model axis cuts the vocab
(distributed/sharding.py: serve_params) each rank holds its columns of
the logits, (N, V / m), described by a `VocabCut`. Every pick takes the
cut and gives each rank the token one device picks from the whole row,
bit for bit:
  * greedy (`greedy`): each rank's max and its first index, offset to
    the whole row, then over "model" the largest value, ties (and a
    NaN, which torch.argmax takes as the max) to the lower index; one
    gather of the ranks' (value, index) pairs, never of the row;
  * `stable_argmax`: the row's max over "model", then each rank's first
    index inside the band, then the lowest over "model"; no row gather;
  * sampled: the threefry bits of a column depend only on (key, column)
    (`random_bits(..., offset=)`), so each rank draws its own columns'
    gumbel noise and the pick is greedy's over logits + noise.
    temperature divides each column alike; top_k takes the k-th value
    from the ranks' own top k values (gathered: m * k values, not the
    row); top_p gathers the row over "model" and draws as one device
    does, since its sorted cumulative softmax needs every column in
    order.
Every reduction over the ranks runs on gathered per-rank values in rank
order, so that all ranks decide alike whatever the backend.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

# one bf16 unit-in-last-place at magnitude ~1
BF16_EPS = 2.0 ** -7
_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)


@dataclasses.dataclass(frozen=True)
class VocabCut:
    """A rank's columns of vocab-parallel logits: rank `rank` of the
    `ranks` ranks of the model axis (its process group `group`) holds
    columns [rank * n, (rank + 1) * n) of each row, n its logits'
    width."""
    group: Any
    rank: int
    ranks: int

    def offset(self, n: int) -> int:
        return self.rank * n

    def stacked(self, t):
        """The ranks' `t` (equal shapes), stacked on a new first dim in
        rank order."""
        from repro_torch.distributed.partial import all_gather_dim
        return all_gather_dim(t.unsqueeze(0), 0, self.group)

    def row(self, t):
        """The whole rows of the ranks' (N, n) columns: (N, m * n)."""
        from repro_torch.distributed.partial import all_gather_dim
        return all_gather_dim(t, t.ndim - 1, self.group)


def vocab_cut(mesh, params=None):
    """The VocabCut of this rank on `mesh`'s model axis; with `params`
    (distributed/sharding.py: serve_params'), None unless they hold a
    vocab-cut table, so that the logits are whole rows."""
    import torch.distributed as dist
    if params is not None:
        from repro_torch.core.optim.base import tree_leaves
        if not any(getattr(getattr(t, "_use", None), "kind", None)
                   == "vocab" for t in tree_leaves(params)):
            return None
    group = mesh.get_group("model")
    return VocabCut(group, dist.get_rank(group), dist.get_world_size(group))


def _first_max(values, idx, cut: VocabCut):
    """Over the ranks of `cut`: the index (N,) of the largest of their
    (N,) `values` at global indices `idx`, the lower rank's on ties and
    the first NaN before any number (torch.argmax's order over the whole
    row: the ranks' columns ascend with their rank)."""
    both = torch.stack([values.double(), idx.double()], dim=-1)
    parts = cut.stacked(both)                          # (m, N, 2)
    best_v, best_i = parts[0, :, 0], parts[0, :, 1]
    for part in parts[1:]:
        v, i = part[:, 0], part[:, 1]
        take = (v > best_v) | (torch.isnan(v) & ~torch.isnan(best_v))
        best_v = torch.where(take, v, best_v)
        best_i = torch.where(take, i, best_i)
    return best_i.to(torch.int32)


def greedy(logits, cut=None):
    """(N, V) fp32 -> (N,) int32 torch.argmax; on a rank's columns
    (cut) the whole row's argmax (_first_max of the ranks' first maxima),
    without gathering the row."""
    if cut is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    idx = torch.argmax(logits, dim=-1, keepdim=True)
    val = torch.gather(logits, -1, idx)[..., 0]
    return _first_max(val, idx[..., 0] + cut.offset(logits.shape[-1]), cut)


def stable_argmax(logits, cut=None):
    """(B, V) fp32 -> (B,) int32: the lowest index within one bf16 ulp
    of the row max, so a one-ulp rounding difference between two
    execution layouts cannot flip the pick. On a rank's columns (cut):
    the row max over the ranks, each rank's first index inside the band,
    the lowest over the ranks (no row gathered)."""
    m = torch.max(logits, dim=-1, keepdim=True).values
    n = logits.shape[-1]
    if cut is not None:
        # the max is exact, so the ranks' maxima give the row's (and a
        # NaN's, which torch.max propagates as the whole row's does)
        m = torch.max(cut.stacked(m), dim=0).values
    band = BF16_EPS * torch.clamp(torch.abs(m), min=1.0)
    tied = logits >= m - band
    off = 0 if cut is None else cut.offset(n)
    width = n if cut is None else n * cut.ranks
    idx = torch.arange(off, off + n, dtype=torch.int32,
                       device=logits.device)
    big = torch.tensor(width, dtype=torch.int32, device=logits.device)
    pick = torch.where(tied, idx, big).min(dim=-1).values
    if cut is not None:
        pick = cut.stacked(pick).min(dim=0).values
    return pick.to(torch.int32)


def nonfinite(logits, cut=None):
    """A 0-d int64: 1 where `logits` hold a NaN or inf, else 0; on a
    rank's columns (cut), where any rank's do, on every rank."""
    bad = (~torch.isfinite(logits)).any().to(torch.int64)
    if cut is not None:
        bad = cut.stacked(bad).max()
    return bad


# --------------------------------------------------------------------------
# threefry2x32, as jax 0.9.0 computes it
# --------------------------------------------------------------------------

def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counter words (x1, x2) under
    key (k1, k2): int64 numpy arrays or torch tensors holding uint32
    values, broadcast together. Returns the two output words the same
    way."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = ((x2 << r) & _MASK) | (x2 >> (32 - r))
            x2 = x1 ^ x2
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def _words(keys, device="cpu"):
    """(..., 2) uint32 keys -> (k1, k2) int64 tensors of shape (...) on
    `device`."""
    k = torch.as_tensor(np.asarray(keys, np.uint32).astype(np.int64),
                        device=device)
    return k[..., 0], k[..., 1]


def prng_key(seed: int) -> np.ndarray:
    """jax.random.PRNGKey(seed): (2,) uint32 [seed >> 32, seed &
    0xffffffff] of the seed as JAX holds it. With jax_enable_x64 off
    (the default, and the JAX package's setting) the seed is a 32-bit
    integer, so the high word is 0 and the low word is the seed modulo
    2**32."""
    return np.array([0, int(seed) & _MASK], np.uint32)


def fold_keys(request_keys, token_indices) -> np.ndarray:
    """(B, 2) keys + (B,) integers -> (B, 2) uint32 keys: row b is
    jax.random.fold_in(request_keys[b], token_indices[b]), the hash of
    the counter pair (0, data) under the key."""
    k = np.asarray(request_keys, np.uint32).astype(np.int64)
    data = np.asarray(token_indices).astype(np.int64) & _MASK
    y1, y2 = threefry2x32(k[..., 0], k[..., 1], np.zeros_like(data), data)
    return np.stack([y1, y2], axis=-1).astype(np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """jax.random.fold_in for one (2,) key and one integer."""
    return fold_keys(np.asarray(key, np.uint32)[None], [data])[0]


def random_bits(keys, n: int, device="cpu", offset: int = 0):
    """(B, 2) keys -> (B, n) int64 tensor of the uint32 values
    jax.random.bits(keys[b], (n,)) draws (partitionable threefry). With
    `offset`, columns [offset, offset + n) of a wider draw: a column's
    bits depend only on the key and its index."""
    k1, k2 = _words(keys, device)
    lo = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k1[:, None], k2[:, None], torch.zeros_like(lo),
                          lo)
    return b1 ^ b2


def uniform(keys, n: int, minval: float = 0.0, maxval: float = 1.0,
            device="cpu", offset: int = 0):
    """(B, 2) keys -> (B, n) fp32 jax.random.uniform draws in [minval,
    maxval): the top 23 random bits as the mantissa of a float in [1, 2),
    minus 1, scaled and shifted in fp32, then held at >= minval. Over
    [0, 1) and [tiny, 1), the sampler's ranges, the scale is exactly 1
    and the result is XLA's bit for bit; elsewhere XLA's fused
    multiply-add may round the scale-and-shift differently. `offset` as
    random_bits'."""
    bits = random_bits(keys, n, device, offset)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    f = f - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def gumbel(keys, n: int, device="cpu", offset: int = 0):
    """(B, 2) keys -> (B, n) fp32 jax.random.gumbel draws, "low" mode
    (`offset` as random_bits')."""
    u = uniform(keys, n, _TINY, 1.0, device, offset)
    return -torch.log(-torch.log(u))


def categorical(keys, logits, cut=None):
    """jax.vmap(jax.random.categorical)(keys, logits): (B, V) fp32
    logits, one (2,) key per row -> (B,) int32, argmax of logits + gumbel
    noise (the first index on ties); on a rank's columns (cut) the
    noise of its columns and the whole row's argmax (greedy)."""
    n = logits.shape[-1]
    g = gumbel(keys, n, logits.device,
               0 if cut is None else cut.offset(n))
    return greedy(g + logits, cut)


@dataclasses.dataclass(frozen=True)
class Sampler:
    """temperature / top-k / top-p sampling with per-row PRNG keys."""
    temperature: float = 1.0
    top_k: int = 0          # 0 disables
    top_p: float = 1.0      # 1.0 disables
    seed: int = 0
    stable_tiebreak: bool = False   # greedy: bf16-ulp tie band, min index

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0

    @classmethod
    def parse(cls, spec) -> "Sampler":
        """"greedy" | "k=v,..." with keys temperature/top_k/top_p/seed/
        stable."""
        if spec is None or isinstance(spec, Sampler):
            return spec
        if spec == "greedy":
            return cls(temperature=0.0)
        kwargs = {}
        for part in spec.split(","):
            k, sep, v = part.partition("=")
            if not sep:
                raise ValueError(f"bad sampler spec item {part!r}")
            k = k.strip()
            if k not in ("temperature", "top_k", "top_p", "seed", "stable"):
                raise ValueError(f"unknown sampler key {k!r}")
            if k == "stable":
                kwargs["stable_tiebreak"] = bool(int(v))
            else:
                kwargs[k] = int(v) if k in ("top_k", "seed") else float(v)
        return cls(**kwargs)

    def sample(self, logits, keys=None, cut=None):
        """logits (B, V) fp32, keys (B, 2) uint32 (unused when greedy)
        -> (B,) int32 tokens. Masking happens in logit space, in fp32,
        before one categorical draw per row. On a rank's vocab-parallel
        columns (cut: VocabCut) the token one device picks from the whole
        row (the module docstring); only top_p < 1 gathers the row."""
        if self.greedy:
            if self.stable_tiebreak:
                return stable_argmax(logits, cut)
            return greedy(logits, cut)
        # a device tensor, not a Python scalar: CUDA divides by a host
        # scalar as a multiply by its reciprocal, one bit off XLA's divide
        t = logits / torch.tensor(self.temperature, dtype=torch.float32,
                                  device=logits.device)
        if cut is not None and self.top_p < 1.0:
            t, cut = cut.row(t), None          # the row, on every rank
        n = t.shape[-1]
        vocab = n if cut is None else n * cut.ranks
        top_k = min(self.top_k, vocab)              # k >= vocab: keep all
        if top_k:
            top = torch.topk(t, min(top_k, n), dim=-1).values
            if cut is not None:     # the row's top k are among the ranks'
                top = torch.topk(cut.row(top), top_k, dim=-1).values
            kth = top[..., -1:]
            t = torch.where(t < kth, -torch.inf, t)
        if self.top_p < 1.0:
            srt = torch.sort(t, dim=-1, descending=True).values
            probs = torch.softmax(srt, dim=-1)
            cum = torch.cumsum(probs, dim=-1)
            # the smallest prefix whose mass reaches top_p (the first
            # token always survives: cum - probs is 0 there)
            keep = (cum - probs) < self.top_p
            thr = torch.where(keep, srt, torch.inf).min(
                dim=-1, keepdim=True).values
            t = torch.where(t < thr, -torch.inf, t)
        return categorical(keys, t, cut)

    def request_key(self, rid: int) -> np.ndarray:
        """fold_in(PRNGKey(seed), rid): the base key of request `rid`."""
        return fold_in(prng_key(self.seed), rid)
