"""Token selection for the serving decode step (port of
repro/serving/sampler.py, greedy part).

`Sampler.parse` reads the same spec strings as the JAX package. Greedy
decoding (`greedy`, or temperature=0) is ported, with the optional
bf16 tie band of `stable_argmax`. Sampled decoding draws from JAX's
threefry keys; without a port of that generator a sampled stream could
not match the reference, so a non-greedy sampler raises.
"""
from __future__ import annotations

import dataclasses

import torch

# one bf16 unit-in-last-place at magnitude ~1
BF16_EPS = 2.0 ** -7


def stable_argmax(logits):
    """(B, V) fp32 -> (B,) int32: the lowest index within one bf16 ulp
    of the row max, so a one-ulp rounding difference between two
    execution layouts cannot flip the pick."""
    m = torch.max(logits, dim=-1, keepdim=True).values
    band = BF16_EPS * torch.clamp(torch.abs(m), min=1.0)
    tied = logits >= m - band
    idx = torch.arange(logits.shape[-1], dtype=torch.int32,
                       device=logits.device)
    big = torch.tensor(logits.shape[-1], dtype=torch.int32,
                       device=logits.device)
    return torch.where(tied, idx, big).min(dim=-1).values.to(torch.int32)


@dataclasses.dataclass(frozen=True)
class Sampler:
    """temperature / top-k / top-p settings; only temperature 0 (greedy)
    decodes in the port so far."""
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    stable_tiebreak: bool = False

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

    def sample(self, logits):
        """logits (B, V) fp32 -> (B,) int32 tokens (greedy only)."""
        if not self.greedy:
            raise NotImplementedError(
                "sampled decoding is not ported yet (it needs JAX's "
                "threefry keys to match the reference); use greedy")
        if self.stable_tiebreak:
            return stable_argmax(logits)
        return torch.argmax(logits, dim=-1).to(torch.int32)
