"""Chunked-prefill admission (port of repro/serving/admission.py).

Whole-prompt admission runs one padded-prompt forward between two decode
steps, so every running stream sees an inter-token gap the size of that
prefill. This module meters prefill work instead: each engine step
carries at most ONE prompt chunk, sized so that

    chunk tokens + active decode tokens  <=  chunk_budget

The chunk advances a per-request prefill task whose KV cache carries
across steps; when the last chunk lands, the task's cache is inserted
into the paged pool like a whole prompt's and the slot joins the decode
batch.

Why the chunk boundaries are token-identical to one whole prefill:
  * a chunk is `Arch.decode_step` over S prompt rows against the task's
    own pooled cache, the incremental write path: rows land at the write
    cursor, positions are the request's local timeline (left pads < 0
    stay masked), and attention attends the CACHE, so each chunk sees
    exactly the rows earlier chunks wrote (masked rows add exact zeros);
  * the task cache is built with clamp_window=False: sliding-window
    layers get full-length rows, so a chunk never reaches attention's
    roll branch (which assumes a prefill from scratch); the window is
    enforced by the (q_pos - k_pos) < window mask, which masks the same
    keys as the ring;
  * chunk sizes are multiples of `chunk_granularity(cfg)`, never below
    2: a one-row cached step takes the fp32-accumulated decode path,
    whose bf16 numerics differ from the prefill's.

What is not preserved is the prefill's reduction shapes, so a chunked
prefill's blocks are never content-addressed for prefix sharing (the
engine inserts with share=False).

No jit and no mesh here: a chunk forward is eager PyTorch under
`torch.no_grad()`, plain code like the rest of the forward (the JAX
package left it to XLA; no Pallas kernel runs in a chunk).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.distributed.sharding import serve_layout
from repro_torch.distributed.steps import build_prefill_step


def chunk_granularity(cfg) -> int:
    """Smallest chunk length the arch supports, never below 2 (a one-row
    cached step is the decode path, whose bf16 numerics differ from the
    prefill path a whole-prompt run uses)."""
    from repro_torch.serving.engine import prompt_granularity
    return max(2, prompt_granularity(cfg))


def plan_chunk(budget: int, n_active: int, granularity: int,
               remaining: int) -> int:
    """Tokens of prefill to fuse into this step: the budget partition.

    Invariants (tests/port/test_torch_admission.py, on an exhaustive
    grid against the JAX package):
      * size + n_active <= budget (decodes are never displaced);
      * size is granularity * 2^k (a bounded set of chunk shapes:
        log2(budget / granularity) + 1 of them);
      * size <= remaining, and remaining - size stays a granularity
        multiple whenever remaining was one;
      * size >= granularity whenever the spare capacity allows, so a
        task always progresses once decodes drain below the budget.
    """
    spare = budget - n_active
    if remaining <= 0 or spare < granularity:
        return 0
    cap = min(spare, remaining)
    size = granularity
    while size * 2 <= cap:
        size *= 2
    return size


def _build_chunk_fn(arch) -> Callable:
    """(params, tokens (1, S), positions (1, S), cache) -> (fp32 logits
    of the last row (1, 1, V), cache written in place)."""
    @torch.no_grad()
    def chunk(params, tokens, positions, cache):
        logits, cache = arch.decode_step(
            params, {"tokens": tokens, "positions": positions}, cache)
        return logits[:, -1:].float(), cache
    return chunk


@dataclasses.dataclass
class PrefillTask:
    """One in-flight chunked admission: a slot-bound prompt prefilled
    chunk by chunk into its own resumable pooled cache."""
    req: object
    slot: int
    prompt: np.ndarray          # full unpadded prompt (+ continuation)
    tokens: np.ndarray          # (1, padded_len) left-padded
    positions: np.ndarray       # (1, padded_len) local timeline, pads < 0
    plen: int
    padded_len: int
    resume_len: int             # tokens re-prefilled after a preemption
    offset: int = 0             # padded rows already chunked
    cache: Optional[dict] = None
    last_logits: Optional[torch.Tensor] = None   # (1, 1, V) fp32
    chunks_run: int = 0

    @property
    def remaining(self) -> int:
        return self.padded_len - self.offset

    @property
    def finished(self) -> bool:
        return self.offset >= self.padded_len


class AdmissionController:
    """Runs at most one PrefillTask, one chunk per engine step. The task
    cache lives on the params' device and is written in place by each
    chunk forward.

    On a serving mesh (`mesh=`, params placed by
    distributed/sharding.py:serve_params) every rank runs the same chunks
    of the same task, and the task cache is placed as the dense pool
    places a cache of one slot: whole on every data rank (one slot does
    not divide over "data"), the model rank's KV heads where the model
    axis cuts attention (its head group's), and its Mamba heads' state
    where it cuts the mixer. The pool's insert then keeps it on the rank that
    holds the slot; the last chunk's logits are the rank's vocab columns
    where the vocab is cut, which the engine's first-token pick takes
    over "model"."""

    def __init__(self, arch, params, *, chunk_budget: int,
                 prefill_len: int, mesh=None):
        if arch.kind != "decoder":
            # chunks run arch.decode_step against a per-slot self-
            # attention cache: the resumable-chunk contract holds for
            # decoder archs only
            raise ValueError(
                f"chunked prefill needs a decoder arch, got {arch.kind}")
        self.arch = arch
        self.params = params
        self.granularity = chunk_granularity(arch.cfg)
        if chunk_budget < self.granularity:
            raise ValueError(
                f"chunk_budget {chunk_budget} < chunk granularity "
                f"{self.granularity} (mamba archs need chunks of "
                f"cfg.mamba_chunk tokens; attention archs need >= 2)")
        self.chunk_budget = chunk_budget
        self.prefill_len = prefill_len
        self.device = params["embed"]["embedding"].device
        self.task: Optional[PrefillTask] = None
        # the task cache is a pool cache of one slot: the model rank's KV
        # heads (its head group's) and Mamba heads where the model axis
        # cuts them (all of them otherwise)
        self._cache_kw = serve_layout(arch.heads, 1, mesh,
                                      arch.mamba).cache_kw(arch.heads[1])
        self._chunk = build_prefill_step(_build_chunk_fn(arch), mesh)
        self.chunks_run = 0          # lifetime chunk forwards
        self.chunk_tokens = 0        # lifetime padded rows chunked
        self.size_counts: Dict[int, int] = {}   # chunk size -> forwards

    def sizes(self):
        """Every chunk size plan_chunk can emit."""
        out, size = [], self.granularity
        while size <= self.chunk_budget:
            out.append(size)
            size *= 2
        return out

    def _fn(self, size: int) -> Callable:
        """The chunk forward of `size` rows. Eager PyTorch compiles
        nothing per shape, so every size shares one function."""
        return self._chunk

    def _fresh_cache(self):
        # clamp_window=False: full-length rows on sliding-window layers
        # keep every chunk on the resumable write path (module docstring)
        return self.arch.init_cache(1, self.prefill_len, device=self.device,
                                    clamp_window=False, **self._cache_kw)

    def warmup(self):
        """Run each chunk size once against a scratch cache, so that the
        first use of each shape (cuBLAS's choice of kernels, the
        allocator's segments) stays out of an open-loop measurement."""
        for size in self.sizes():
            tokens = torch.zeros((1, size), dtype=torch.int32,
                                 device=self.device)
            positions = torch.arange(size, dtype=torch.int32,
                                     device=self.device)[None]
            logits, _ = self._fn(size)(self.params, tokens, positions,
                                       self._fresh_cache())
            logits.cpu()

    def start(self, req, slot: int, tokens: np.ndarray,
              positions: np.ndarray, *, plen: int, padded_len: int,
              resume_len: int, prompt: np.ndarray):
        if self.task is not None:
            raise RuntimeError("a prefill task is already in flight")
        if padded_len % self.granularity != 0:
            raise ValueError(
                f"padded prompt length {padded_len} not a multiple of "
                f"chunk granularity {self.granularity}")
        self.task = PrefillTask(req=req, slot=slot, prompt=prompt,
                                tokens=tokens, positions=positions,
                                plen=plen, padded_len=padded_len,
                                resume_len=resume_len)

    def advance(self, n_active: int) -> bool:
        """Run this step's chunk, if the budget partition grants one.
        Returns True when the task progressed; the engine checks
        `task.finished` and finalizes (pool insert + first token)."""
        task = self.task
        if task is None:
            return False
        size = plan_chunk(self.chunk_budget, n_active, self.granularity,
                          task.remaining)
        if size == 0:
            return False
        if task.cache is None:
            task.cache = self._fresh_cache()
        rows = slice(task.offset, task.offset + size)
        logits, task.cache = self._fn(size)(
            self.params,
            torch.as_tensor(task.tokens[:, rows], device=self.device),
            torch.as_tensor(task.positions[:, rows], device=self.device),
            task.cache)
        task.offset += size
        task.chunks_run += 1
        self.chunks_run += 1
        self.chunk_tokens += size
        self.size_counts[size] = self.size_counts.get(size, 0) + 1
        if task.finished:
            task.last_logits = logits
        return True

    def drop(self):
        """Forget the current task (finalized, or requeued after a
        NoBlocksError at insert: the continuation re-chunks identically,
        so dropping mid-task never loses exactness)."""
        self.task = None
