"""The port's open-loop traffic (serving/traffic.py) against the JAX
package: seeded arrivals and the bimodal workload bit for bit, SLO
accounting on the same traces, the driver on a fake clock, and the
open-loop replay identity (chunked and unchunked engines on one arrival
schedule emit the same tokens, and the JAX engine's)."""
import dataclasses

import numpy as np
import pytest

from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import OpenLoopDriver as JaxDriver
from repro.serving import SLO as JaxSLO
from repro.serving import bimodal_requests as jax_bimodal
from repro.serving import meets_slo as jax_meets_slo
from repro.serving import poisson_arrivals as jax_poisson
from repro.serving import slo_report as jax_slo_report
from repro.serving.metrics import RequestTrace as JaxTrace
from repro_torch.serving import (SLO, ContinuousEngine, OpenLoopDriver,
                                 Request, bimodal_requests, meets_slo,
                                 poisson_arrivals, slo_report)
from repro_torch.serving.metrics import RequestTrace

MAX_LEN = 48


@pytest.mark.parametrize("n, rate, seed, start", [
    (64, 10.0, 3, 0.0), (12, 2.0, 2, 0.0), (6, 50.0, 2, 0.0),
    (1, 0.5, 0, 1.25), (300, 1e3, 123456789, 7.0)])
def test_poisson_arrivals_equal_jax(n, rate, seed, start):
    got = poisson_arrivals(n, rate, seed=seed, start=start)
    want = jax_poisson(n, rate, seed=seed, start=start)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.all(np.diff(got) > 0) and got[0] > start


def test_poisson_arrivals_rejects_a_nonpositive_rate():
    for rate in (0.0, -1.0):
        with pytest.raises(ValueError, match="rate_per_s must be positive"):
            poisson_arrivals(4, rate)


@pytest.mark.parametrize("kw", [
    dict(n=12, vocab=256000, short_len=64, long_len=512, new_tokens=32,
         long_frac=0.25, seed=4),
    dict(n=16, vocab=1024, short_len=8, long_len=64, new_tokens=4,
         long_frac=0.5, seed=9),
    dict(n=6, vocab=1024, short_len=5, long_len=24, new_tokens=4,
         long_frac=0.5, seed=4)])
def test_bimodal_requests_equal_jax(kw):
    got, want = bimodal_requests(**kw), jax_bimodal(**kw)
    assert [type(r) for r in got] == [Request] * len(want)
    for a, b in zip(got, want):
        assert a.prompt.dtype == b.prompt.dtype
        assert np.array_equal(a.prompt, b.prompt)
        assert a.max_new_tokens == b.max_new_tokens
    lens = [len(r.prompt) for r in got]
    assert min(lens) >= 1 and max(lens) <= kw["long_len"]


def _trace(cls, submit, token_ts):
    t = cls(submit_t=submit)
    for ts in token_ts:
        t.mark_token(ts)
    return t


@dataclasses.dataclass
class _Done:
    trace: object
    generated: object


def test_slo_report_equals_jax_on_the_same_traces():
    """Random traces (some unfinished, some with no token) through both
    packages' slo_report, at several SLOs: equal dicts, value for value;
    and the hand-checked case of tests/test_admission.py."""
    rng = np.random.default_rng(0)
    for _ in range(50):
        port, ref = [], []
        for _ in range(int(rng.integers(1, 9))):
            submit = float(rng.uniform(0, 1))
            ts = (submit + np.cumsum(rng.exponential(0.05, size=int(
                rng.integers(0, 6))))).tolist()
            done = None if rng.random() < 0.2 else list(range(len(ts)))
            port.append(_Done(_trace(RequestTrace, submit, ts), done))
            ref.append(_Done(_trace(JaxTrace, submit, ts), done))
        ttft, itl = float(rng.uniform(10, 200)), float(rng.uniform(5, 80))
        wall = float(rng.choice([0.0, rng.uniform(0.1, 3)]))
        got = slo_report(port, SLO(ttft, itl), wall)
        assert got == jax_slo_report(ref, JaxSLO(ttft, itl), wall)
        for p, r in zip(port, ref):
            assert (meets_slo(p.trace, SLO(ttft, itl))
                    == jax_meets_slo(r.trace, JaxSLO(ttft, itl)))
    slo = SLO(ttft_ms=100.0, itl_ms=50.0)
    good = _trace(RequestTrace, 0.0, [0.05, 0.08, 0.12])
    late_first = _trace(RequestTrace, 0.0, [0.2, 0.22])
    stalled = _trace(RequestTrace, 0.0, [0.05, 0.30])
    rep = slo_report([_Done(good, [1, 2, 3]), _Done(late_first, [1, 2]),
                      _Done(stalled, [1, 2])], slo, wall_s=1.0)
    assert rep["goodput_tokens_per_s"] == 3.0 and rep["tokens_per_s"] == 7.0
    assert rep["ttft_violations"] == 1 and rep["itl_violations"] == 1
    assert rep["slo_attainment"] == pytest.approx(1 / 3)
    with pytest.raises(ValueError, match="must be positive"):
        SLO(ttft_ms=0.0, itl_ms=1.0)


def test_open_loop_driver_fake_clock():
    """On a fake clock, both packages' drivers submit each request at
    its arrival offset (never early, in arrival order whatever the input
    order), step the engine only when it has work, sleep to the next
    arrival when idle, and return the same wall time."""
    logs = []
    for driver in (OpenLoopDriver, JaxDriver):
        clock = {"t": 5.0}              # nonzero base: offsets, not epochs

        class FakeEngine:
            def __init__(self):
                self.log = []
                self.pending = 0

                class Sched:
                    has_work = property(lambda s: self.pending > 0)
                self.scheduler = Sched()

            def submit(self, req):
                self.log.append(("submit", req, clock["t"]))
                self.pending += 1

            def step(self):
                self.log.append(("step", None, clock["t"]))
                clock["t"] += 0.01      # a step costs 10 ms
                self.pending -= 1       # one request finishes per step

        def sleep(dt):
            assert dt > 0
            clock["t"] += max(dt, 1e-6)

        eng = FakeEngine()
        arrivals = [0.30, 0.02, 0.30]   # a burst after an idle gap
        wall = driver(eng, ["c", "a", "b"], arrivals,
                      time_fn=lambda: clock["t"], sleep_fn=sleep).run()
        subs = [(r, t - 5.0) for op, r, t in eng.log if op == "submit"]
        assert [r for r, _ in subs] == ["a", "c", "b"]
        for (_, t), arr in zip(subs, sorted(arrivals)):
            assert t >= arr - 1e-9
        assert sum(op == "step" for op, _, _ in eng.log) == 3
        assert wall == pytest.approx(clock["t"] - 5.0)
        logs.append((eng.log, wall))
    assert logs[0] == logs[1]
    with pytest.raises(ValueError, match="1 requests but 2 arrivals"):
        OpenLoopDriver(None, ["a"], [0.1, 0.2])


def test_open_loop_replay_identity(gemma_pair):
    """One seeded arrival schedule replayed through the port's chunked
    and unchunked engines (kernel path, its plain version on the CPU):
    every request completes, the tokens are equal, and they equal the
    JAX chunked engine's open-loop replay (open-loop timing, queue order
    and chunk sizes never reach the output)."""
    jarch, jparams, tarch, tparams = gemma_pair
    arrivals = poisson_arrivals(6, 50.0, seed=2)
    kw = dict(short_len=5, long_len=24, new_tokens=4, long_frac=0.5, seed=4)
    eng_kw = dict(max_batch=3, max_len=MAX_LEN, policy="fp32",
                  cache="paged", block_size=8, prefill_bucket=8)
    outs = []
    for chunk_budget in (None, 6):
        reqs = bimodal_requests(6, tarch.cfg.vocab, **kw)
        eng = ContinuousEngine(tarch, tparams, attn_kernel="paged",
                               chunk_budget=chunk_budget, **eng_kw)
        wall = OpenLoopDriver(eng, reqs, arrivals).run()
        assert wall > 0 and all(r.generated is not None for r in reqs)
        rep = slo_report(reqs, SLO(1e6, 1e6), wall)
        assert rep["completed"] == 6 and rep["slo_attainment"] == 1.0
        outs.append([r.generated.tolist() for r in reqs])
    assert outs[0] == outs[1]
    jreqs = jax_bimodal(6, jarch.cfg.vocab, **kw)
    JaxDriver(JaxEngine(jarch, jparams, chunk_budget=6, **eng_kw), jreqs,
              jax_poisson(6, 50.0, seed=2)).run()
    assert outs[1] == [r.generated.tolist() for r in jreqs]
