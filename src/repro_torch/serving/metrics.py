"""Serving-side latency/throughput accounting (copy of
repro/serving/metrics.py: pure host bookkeeping).

Each request carries a `RequestTrace` of wall-clock events: submission,
admission (prefill done, first token available) and one timestamp per
generated token. `aggregate()` folds a set of traces into the numbers a
serving dashboard wants:

  tokens_per_s   generated tokens / wall
  ttft_*_ms      time-to-first-token percentiles (submit -> first token;
                 includes queue wait, so under bursty arrivals this is
                 the number scheduling policy changes move)
  itl_*_ms       inter-token latency percentiles (gaps between tokens of
                 the same request — the per-token latency of the decode
                 loop, which is what slot reuse and low-precision decode
                 are meant to shrink)

The trace also counts scheduler interventions per request: `preemptions`
(times the request was evicted mid-decode and requeued as a continuation
prefill) and `evicted_slo` (the slot blew its SLO and was finished
early with the tokens it had). `DepthTracker` folds per-step queue-depth
samples into max/mean/p50 — the congestion signal the policy-driven
scheduler reports next to TTFT.

No tensors here: this is pure host bookkeeping and must stay off the
decode hot path.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional


@dataclasses.dataclass
class RequestTrace:
    submit_t: float = 0.0
    admit_t: Optional[float] = None
    first_token_t: Optional[float] = None
    done_t: Optional[float] = None
    token_ts: List[float] = dataclasses.field(default_factory=list)
    preemptions: int = 0        # mid-decode evict + continuation requeues
    evicted_slo: bool = False   # finished early by SLO eviction

    def mark_submit(self, now=None):
        self.submit_t = time.perf_counter() if now is None else now

    def mark_token(self, now=None):
        now = time.perf_counter() if now is None else now
        if self.first_token_t is None:
            self.first_token_t = now
        self.token_ts.append(now)

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t

    @property
    def inter_token_s(self) -> List[float]:
        return [b - a for a, b in zip(self.token_ts, self.token_ts[1:])]


def percentile(xs: List[float], q: float) -> float:
    """Nearest-rank percentile; 0.0 on empty input (keeps JSON simple)."""
    if not xs:
        return 0.0
    xs = sorted(xs)
    k = min(len(xs) - 1, max(0, int(round(q / 100.0 * (len(xs) - 1)))))
    return xs[k]


def hit_rate(hits: int, misses: int) -> float:
    """hits / (hits + misses); 0.0 when there was no demand at all.
    Used for the retained-prefix LRU telemetry (cache_pool)."""
    total = hits + misses
    return hits / total if total > 0 else 0.0


class DepthTracker:
    """Folds per-step queue-depth samples into max/mean/p50 with O(1)
    memory per sample: max/sum/count stream, and the p50 reads a
    bounded ring of the most recent samples (a long-lived engine takes
    one sample per decode step forever — an unbounded list would be a
    slow leak, and recent depth is the operationally relevant median
    anyway)."""

    RING = 4096        # p50 window; max/mean remain exact over all time

    def __init__(self):
        self.count = 0
        self.total = 0
        self.peak = 0
        self._ring: List[int] = [0] * self.RING
        self._i = 0

    def sample(self, depth: int):
        depth = int(depth)
        self.count += 1
        self.total += depth
        if depth > self.peak:
            self.peak = depth
        self._ring[self._i % self.RING] = depth
        self._i += 1

    def stats(self, prefix: str = "queue_depth") -> Dict[str, float]:
        recent = self._ring[:min(self.count, self.RING)]
        return {
            f"{prefix}_max": self.peak,
            f"{prefix}_mean": self.total / self.count if self.count else 0.0,
            f"{prefix}_p50": percentile([float(x) for x in recent], 50),
        }


def aggregate(traces: List[RequestTrace], wall_s: float,
              n_tokens: int) -> Dict[str, float]:
    ttfts = [t.ttft_s for t in traces if t.ttft_s is not None]
    itls: List[float] = []
    for t in traces:
        itls.extend(t.inter_token_s)
    return {
        "requests": len(traces),
        "tokens": n_tokens,
        "wall_s": wall_s,
        "tokens_per_s": n_tokens / wall_s if wall_s > 0 else 0.0,
        "ttft_p50_ms": percentile(ttfts, 50) * 1e3,
        "ttft_p99_ms": percentile(ttfts, 99) * 1e3,
        "itl_p50_ms": percentile(itls, 50) * 1e3,
        "itl_p99_ms": percentile(itls, 99) * 1e3,
        "preemptions": sum(t.preemptions for t in traces),
        "slo_evictions": sum(1 for t in traces if t.evicted_slo),
    }
