"""Open-loop traffic: seeded Poisson arrivals, TTFT/ITL SLOs, goodput
(copy of repro/serving/traffic.py: numpy and the host clock only).

Closed-loop load (run_batch over a pre-built list) measures peak
tokens/s: the generator waits for the system, so the system never
falls behind. Production traffic does not wait — requests arrive on
their own clock, queues build when the server stalls, and the metric
that models millions-of-users capacity is GOODPUT: tokens/s delivered
by requests that met their latency SLOs, at a fixed arrival rate
(PAPERS.md: cost-efficient multi-node serving argues goodput per fixed
hardware, not peak throughput, is the capacity number).

This module is the open-loop side of that measurement:

  poisson_arrivals  seeded exponential inter-arrival times — the
                    memoryless process whose bursts expose prefill
                    stalls that uniform pacing hides;
  SLO               per-request TTFT (submit -> first token) and ITL
                    (every inter-token gap) bounds, in milliseconds;
  meets_slo         a request is GOOD iff its TTFT met the bound AND
                    no single inter-token gap exceeded the ITL bound —
                    one whole-prompt prefill stalling a stream past
                    the ITL SLO disqualifies the entire stream;
  slo_report        goodput + attainment + violation counts, JSON-able;
  bimodal_requests  the mixed workload: mostly short prompts (decode
                    traffic) + a long-prompt minority whose admissions
                    stall everyone else unless prefill is chunked;
  OpenLoopDriver    submits requests at their arrival offsets while
                    stepping a ContinuousEngine.

Host-side only (numpy + wall clock); the clock and sleep are injectable
so scheduling tests can drive the loop deterministically. The
engine syncs with the device on every step (its tokens come back to the
host), so the wall clock ends with the device's work.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Sequence

import numpy as np

from repro_torch.serving.metrics import RequestTrace, percentile


@dataclasses.dataclass(frozen=True)
class SLO:
    """Per-request latency bounds, milliseconds."""
    ttft_ms: float
    itl_ms: float

    def __post_init__(self):
        if self.ttft_ms <= 0 or self.itl_ms <= 0:
            raise ValueError(f"SLO bounds must be positive, got {self}")


def poisson_arrivals(n: int, rate_per_s: float, seed: int = 0,
                     start: float = 0.0) -> np.ndarray:
    """(n,) arrival offsets in seconds: a seeded Poisson process of
    `rate_per_s` requests/s (exponential inter-arrival gaps)."""
    if rate_per_s <= 0:
        raise ValueError(f"rate_per_s must be positive, got {rate_per_s}")
    rng = np.random.default_rng(seed)
    return start + np.cumsum(rng.exponential(1.0 / rate_per_s, size=n))


def bimodal_requests(n: int, vocab: int, *, short_len: int, long_len: int,
                     new_tokens: int, long_frac: float = 0.25,
                     seed: int = 0) -> List:
    """Mixed open-loop workload: ~(1 - long_frac) short prompts and a
    long-prompt minority. The short streams are the ITL victims; each
    long admission is the stall. Pure function of the arguments, so the
    chunked and unchunked engines see byte-identical requests."""
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n):
        base = long_len if rng.random() < long_frac else short_len
        plen = int(rng.integers(max(1, base * 3 // 4), base + 1))
        reqs.append(Request(
            prompt=rng.integers(5, vocab, size=plen).astype(np.int32),
            max_new_tokens=new_tokens))
    return reqs


def ttft_violated(trace: RequestTrace, slo: SLO) -> bool:
    ttft = trace.ttft_s
    return ttft is None or ttft * 1e3 > slo.ttft_ms


def itl_violated(trace: RequestTrace, slo: SLO) -> bool:
    return any(gap * 1e3 > slo.itl_ms for gap in trace.inter_token_s)


def meets_slo(trace: RequestTrace, slo: SLO) -> bool:
    return not ttft_violated(trace, slo) and not itl_violated(trace, slo)


def slo_report(requests: Sequence, slo: SLO, wall_s: float) -> Dict:
    """Goodput + SLO attainment over a finished open-loop run.

    goodput_tokens_per_s counts ONLY tokens of requests that met both
    bounds; tokens_per_s counts everything (the closed-loop number).
    """
    done = [r for r in requests if r.generated is not None]
    good = [r for r in done if meets_slo(r.trace, slo)]
    ttfts = [r.trace.ttft_s for r in done if r.trace.ttft_s is not None]
    itls = [g for r in done for g in r.trace.inter_token_s]
    good_tokens = sum(len(r.generated) for r in good)
    all_tokens = sum(len(r.generated) for r in done)
    return {
        "requests": len(requests),
        "completed": len(done),
        "wall_s": wall_s,
        "slo_ttft_ms": slo.ttft_ms,
        "slo_itl_ms": slo.itl_ms,
        "goodput_tokens_per_s": good_tokens / wall_s if wall_s > 0 else 0.0,
        "tokens_per_s": all_tokens / wall_s if wall_s > 0 else 0.0,
        "slo_attainment": len(good) / len(done) if done else 0.0,
        "ttft_violations": sum(ttft_violated(r.trace, slo) for r in done),
        "itl_violations": sum(itl_violated(r.trace, slo) for r in done),
        "ttft_p50_ms": percentile(ttfts, 50) * 1e3,
        "ttft_p99_ms": percentile(ttfts, 99) * 1e3,
        "itl_p50_ms": percentile(itls, 50) * 1e3,
        "itl_p99_ms": percentile(itls, 99) * 1e3,
    }


class OpenLoopDriver:
    """Submit requests at their arrival offsets while stepping the
    engine — the generator does not wait for the server.

    Each loop iteration submits every request whose arrival time has
    passed, then runs one engine step if there is work; when the engine
    is idle and the next arrival is in the future, it sleeps until that
    arrival. time_fn/sleep_fn are injectable so tests can drive the
    loop on a fake clock (tests/port/test_torch_traffic.py)."""

    def __init__(self, engine, requests: Sequence,
                 arrivals: Sequence[float], *,
                 time_fn: Callable[[], float] = time.perf_counter,
                 sleep_fn: Callable[[float], None] = time.sleep):
        if len(requests) != len(arrivals):
            raise ValueError(
                f"{len(requests)} requests but {len(arrivals)} arrivals")
        order = np.argsort(np.asarray(arrivals, float), kind="stable")
        self.engine = engine
        self.requests = [requests[i] for i in order]
        self.arrivals = [float(arrivals[i]) for i in order]
        self.time_fn = time_fn
        self.sleep_fn = sleep_fn
        self.submitted = 0

    def run(self) -> float:
        """Drive to completion; returns the measured wall seconds."""
        base = self.time_fn()
        n = len(self.requests)
        while self.submitted < n or self.engine.scheduler.has_work:
            now = self.time_fn() - base
            while self.submitted < n and \
                    self.arrivals[self.submitted] <= now:
                self.engine.submit(self.requests[self.submitted])
                self.submitted += 1
            if self.engine.scheduler.has_work:
                self.engine.step()
            elif self.submitted < n:
                wait = self.arrivals[self.submitted] - (self.time_fn() - base)
                if wait > 0:
                    self.sleep_fn(wait)
        return self.time_fn() - base
