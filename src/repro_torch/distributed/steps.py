"""The serving decode step (port of repro/distributed/steps.py,
build_serve_step and greedy_next, single device).

PyTorch runs eagerly, so where the JAX package jitted the step once per
cache shape the port returns a plain function. The cache (arenas,
tables, cursors) is written in place by the step.
"""
from __future__ import annotations

from typing import Callable

import torch


def greedy_next(logits):
    """(B, 1, V) -> (B,) int32 greedy pick."""
    return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)


def build_serve_step(decode_fn: Callable, *, sampler=None):
    """decode_fn(params, batch, cache) -> (logits, cache), e.g.
    Arch.decode_step. Returns

        step(params, tokens (B, 1), positions (B, 1), cache)
            -> (next_tokens (B,) int32, cache)

    picking tokens from fp32 logits. A non-greedy sampler raises (see
    serving/sampler.py)."""
    if sampler is not None and not sampler.greedy:
        raise NotImplementedError("sampled decoding is not ported yet")
    stable = sampler is not None and sampler.stable_tiebreak

    @torch.no_grad()
    def step(params, tokens, positions, cache):
        logits, new_cache = decode_fn(
            params, {"tokens": tokens, "positions": positions}, cache)
        logits = logits.float()
        if stable:
            return sampler.sample(logits[:, -1, :]), new_cache
        return greedy_next(logits), new_cache

    return step
