"""The port's chunked-prefill admission (serving/admission.py and the
engine's chunked path) against itself and the JAX package, on reduced
archs with the weights carried over by repro_torch.bridge (the claims of
tests/test_admission.py):

  * plan_chunk equals JAX's over an exhaustive grid, with its
    invariants; the controller's sizes and guards, with JAX's messages;
  * chunked prefill is token-identical to whole-prompt prefill: fp32
    across every layout (static == dense == paged == chunked) and equal
    to the JAX chunked engine's tokens and chunk counters; bf16 within
    one layout (paged whole vs paged chunked, plain and tie-stable
    greedy), equal to JAX's chunked tokens;
  * a scarce arena (dynamic watermark, finalize requeue, preemption
    around in-flight tasks) stays output-invisible and keeps the pool's
    invariants, with JAX's counters;
  * the scheduling policies: the resume-cost victim and the
    arrival-deadline policy's pick and victim equal JAX's.
"""
import itertools

import jax
import numpy as np
import pytest

from repro.configs import reduced_arch as jreduced
from repro.serving import AdmissionController as JaxController
from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import PolicyContext as JaxContext
from repro.serving import Request as JaxRequest
from repro.serving import SchedulingPolicy as JaxPolicy
from repro.serving import plan_chunk as jax_plan_chunk
from repro.serving.metrics import RequestTrace as JaxTrace
from repro_torch.bridge import params_from_jax
from repro_torch.configs import reduced_arch as treduced
from repro_torch.serving import (AdmissionController, ContinuousEngine,
                                 PolicyContext, Request, SchedulingPolicy,
                                 ServeEngine, chunk_granularity, plan_chunk)
from repro_torch.serving.metrics import RequestTrace

MAX_LEN = 48
SPEC = [(7, 4), (23, 6), (5, 1), (17, 3), (11, 4)]
SCARCE = [(7, 10), (23, 10), (11, 10), (17, 10)]


def make_requests(cls, vocab, spec=SPEC, seed=1):
    """tests/conftest.make_serving_requests (no prefix), for either
    package."""
    return [cls(prompt=np.random.default_rng([seed, i]).integers(
                    5, vocab, size=n).astype(np.int32), max_new_tokens=m)
            for i, (n, m) in enumerate(spec)]


def tokens_of(reqs):
    return [r.generated.tolist() for r in reqs]


def chunked_engine(cls, arch, params, policy="fp32", sampler="greedy",
                   **kw):
    """tests/test_admission.py's chunked engine, for either package."""
    kw.setdefault("chunk_budget", 6)
    return cls(arch, params, max_batch=3, max_len=MAX_LEN, policy=policy,
               cache="paged", block_size=8, prefill_bucket=8,
               sampler=sampler, **kw)


_pairs = {}


def arch_pair(name):
    """(JAX arch, JAX params, port arch, port params), memoized."""
    if name not in _pairs:
        jarch, tarch = jreduced(name), treduced(name)
        jparams = jarch.init(jax.random.PRNGKey(0))
        _pairs[name] = (jarch, jparams, tarch, params_from_jax(
            tarch.cfg, jax.tree.map(np.asarray, jparams)))
    return _pairs[name]


_jax_runs = {}


def jax_chunked(name, spec=SPEC, **kw):
    """The JAX chunked engine's (report, tokens) on `spec`, memoized."""
    key = (name, tuple(spec), tuple(sorted(kw.items())))
    if key not in _jax_runs:
        jarch, jparams, _, _ = arch_pair(name)
        reqs = make_requests(JaxRequest, jarch.cfg.vocab, spec)
        eng = chunked_engine(JaxEngine, jarch, jparams, **kw)
        eng.run_batch(reqs)
        _jax_runs[key] = (eng.report(1.0), tokens_of(reqs))
    return _jax_runs[key]


# --------------------------------------------------------------------------
# the budget partition and the controller
# --------------------------------------------------------------------------

def test_plan_chunk_equals_jax_on_a_grid():
    """Every (budget 2-32, decoding slots 0-32, granularity 2 and 4,
    remaining 0-64): the port's chunk size equals JAX's, and the
    invariants of admission.py hold (budget conserved, sizes
    granularity * 2^k, progress whenever the spare capacity allows, and
    on a granularity multiple no overshoot and no unreachable tail)."""
    for budget, n_active, g, remaining in itertools.product(
            range(2, 33), range(33), (2, 4), range(65)):
        size = plan_chunk(budget, n_active, g, remaining)
        assert size == jax_plan_chunk(budget, n_active, g, remaining)
        if size:
            q = size // g
            assert size % g == 0 and q & (q - 1) == 0
            assert size + n_active <= budget
            if remaining % g == 0:       # a padded prompt's remainder
                assert size <= remaining and (remaining - size) % g == 0
        else:
            assert remaining <= 0 or budget - n_active < g


def test_controller_sizes_and_guards_match_jax():
    jarch, jparams, tarch, tparams = arch_pair("gemma2-2b")
    ctrl = AdmissionController(tarch, tparams, chunk_budget=12,
                               prefill_len=MAX_LEN)
    jctrl = JaxController(jarch, jparams, chunk_budget=12,
                          prefill_len=MAX_LEN)
    g = chunk_granularity(tarch.cfg)
    assert ctrl.granularity == jctrl.granularity == g == 2
    assert ctrl.sizes() == jctrl.sizes() == [2, 4, 8]
    assert set(plan_chunk(12, a, g, 64) for a in range(13)) <= \
        set(ctrl.sizes()) | {0}

    def message(fn):
        with pytest.raises(ValueError) as e:
            fn()
        return str(e.value)

    assert (message(lambda: AdmissionController(
                tarch, tparams, chunk_budget=1, prefill_len=MAX_LEN))
            == message(lambda: JaxController(
                jarch, jparams, chunk_budget=1, prefill_len=MAX_LEN)))
    assert (message(lambda: ContinuousEngine(
                tarch, tparams, max_batch=2, max_len=MAX_LEN,
                cache="dense", chunk_budget=8))
            == message(lambda: JaxEngine(
                jarch, jparams, max_batch=2, max_len=MAX_LEN,
                cache="dense", chunk_budget=8)))
    assert (message(lambda: ContinuousEngine(
                tarch, tparams, max_batch=2, max_len=MAX_LEN,
                spec_draft=(tarch, tparams), chunk_budget=8))
            == message(lambda: JaxEngine(
                jarch, jparams, max_batch=2, max_len=MAX_LEN,
                spec_draft=(jarch, jparams), chunk_budget=8)))
    bert = treduced("bert-large")
    with pytest.raises(ValueError, match="needs a decoder arch, got bert"):
        AdmissionController(bert, tparams, chunk_budget=8,
                            prefill_len=MAX_LEN)
    # the engine rounds its prefill bucket up to the granularity
    eng = ContinuousEngine(tarch, tparams, max_batch=2, max_len=MAX_LEN,
                           prefill_bucket=7, chunk_budget=8)
    assert eng.prefill_bucket == 8


def test_controller_chunks_a_prompt_like_a_whole_prefill():
    """Driven by hand: the task cache has unclamped sliding-window rows
    (prefill_len, not the window), chunks advance by plan_chunk's sizes,
    and the last chunk's logits equal a whole-prompt prefill's."""
    import torch
    from repro_torch.serving import build_prefill_fn, pad_prompts
    _, _, tarch, tparams = arch_pair("gemma2-2b")
    ctrl = AdmissionController(tarch, tparams, chunk_budget=8,
                               prefill_len=64)
    prompt = np.random.default_rng(3).integers(5, 1000, 21).astype(np.int32)
    tokens, positions, _ = pad_prompts([prompt], 8)
    ctrl.start("req", 0, tokens, positions, plen=21, padded_len=24,
               resume_len=0, prompt=prompt)
    sizes = []
    for n_active in (2, 5, 7, 0, 0, 0):
        before = ctrl.task.offset
        ctrl.advance(n_active)
        sizes.append(ctrl.task.offset - before)
        if ctrl.task.finished:
            break
    assert sizes == [4, 2, 0, 8, 8, 2]
    assert ctrl.chunks_run == 5 and ctrl.chunk_tokens == 24
    assert ctrl.size_counts == {2: 2, 4: 1, 8: 2}
    assert [s["k"].shape[2] for s in ctrl.task.cache["slots"]] == [64, 64]
    want, _ = build_prefill_fn(tarch, 64)(
        tparams, torch.as_tensor(tokens), torch.as_tensor(positions))
    torch.testing.assert_close(ctrl.task.last_logits, want, rtol=1e-5,
                               atol=1e-5)
    ctrl.warmup()
    with pytest.raises(RuntimeError, match="already in flight"):
        ctrl.start("req", 1, tokens, positions, plen=21, padded_len=24,
                   resume_len=0, prompt=prompt)
    ctrl.drop()
    assert ctrl.task is None


# --------------------------------------------------------------------------
# chunk-boundary exactness
# --------------------------------------------------------------------------

def test_chunked_quad_identity_fp32():
    """static == dense == paged == chunked (kernel path, its plain
    version on the CPU, and the gather path) in the port, greedy fp32."""
    _, _, arch, params = arch_pair("gemma2-2b")
    outs = []
    for build in (
            lambda: ServeEngine(arch, params, max_len=MAX_LEN,
                                policy="fp32"),
            lambda: ContinuousEngine(arch, params, max_batch=2,
                                     max_len=MAX_LEN, policy="fp32",
                                     cache="dense", prefill_bucket=8),
            lambda: ContinuousEngine(arch, params, max_batch=3,
                                     max_len=MAX_LEN, policy="fp32",
                                     cache="paged", block_size=8,
                                     prefill_bucket=8),
            lambda: chunked_engine(ContinuousEngine, arch, params,
                                   attn_kernel="paged"),
            lambda: chunked_engine(ContinuousEngine, arch, params,
                                   attn_kernel="xla")):
        reqs = make_requests(Request, arch.cfg.vocab)
        build().run_batch(reqs)
        outs.append(tokens_of(reqs))
    assert all(o == outs[0] for o in outs[1:])


@pytest.mark.parametrize("attn_kernel", ["paged", "xla"])
def test_chunked_engine_matches_jax_chunked_engine(attn_kernel):
    """Tokens, chunk forwards and chunked rows equal the JAX chunked
    engine's (its XLA path); chunked blocks are never content-addressed,
    so nothing hits or misses the prefix registry."""
    _, _, arch, params = arch_pair("gemma2-2b")
    jrep, want = jax_chunked("gemma2-2b")
    reqs = make_requests(Request, arch.cfg.vocab)
    eng = chunked_engine(ContinuousEngine, arch, params,
                         attn_kernel=attn_kernel)
    eng.run_batch(reqs)
    assert tokens_of(reqs) == want
    rep = eng.report(1.0)
    for key in ("chunk_budget", "chunk_steps", "chunk_tokens",
                "decode_steps", "prefix_misses", "shared_block_hits"):
        assert rep[key] == jrep[key], key
    assert rep["prefix_misses"] == 0
    assert rep["chunk_steps"] >= len(SPEC)
    assert rep["chunk_tokens"] >= sum(-(-n // 8) * 8 for n, _ in SPEC)
    assert sum(rep["chunk_sizes"].values()) == rep["chunk_steps"]
    assert rep["nonfinite_logit_steps"] == 0
    eng.pool.check_invariants()
    eng.scheduler.check_invariants()


@pytest.mark.parametrize("sampler", ["greedy", "temperature=0,stable=1"])
def test_chunked_bf16_same_layout(sampler):
    """bf16 within one layout (reduced qwen2.5-14b): paged whole-prompt
    == paged chunked in the port, plain greedy and the tie-stable argmax,
    and the port's chunked tokens equal the JAX chunked engine's."""
    _, _, arch, params = arch_pair("qwen2.5-14b")
    outs = []
    for chunk_budget in (None, 6):
        reqs = make_requests(Request, arch.cfg.vocab)
        chunked_engine(ContinuousEngine, arch, params, policy="bf16",
                       sampler=sampler, attn_kernel="paged",
                       chunk_budget=chunk_budget).run_batch(reqs)
        outs.append(tokens_of(reqs))
    assert outs[0] == outs[1]
    _, want = jax_chunked("qwen2.5-14b", policy="bf16", sampler=sampler)
    assert outs[1] == want


def test_chunked_scarce_arena_requeue_invisible():
    """A 2-slot arena under 3 slots with budgets of 10: decode growth
    preempts around in-flight chunk tasks and the dynamic watermark
    holds admissions back; the tokens still equal an unconstrained
    whole-prefill run, the pool's invariants hold, and the counters
    equal the JAX chunked engine's."""
    _, _, arch, params = arch_pair("gemma2-2b")
    reqs = make_requests(Request, arch.cfg.vocab, SCARCE)
    ContinuousEngine(arch, params, max_batch=2, max_len=MAX_LEN,
                     policy="fp32", cache="paged", block_size=8,
                     prefill_bucket=8).run_batch(reqs)
    want = tokens_of(reqs)
    reqs = make_requests(Request, arch.cfg.vocab, SCARCE)
    eng = chunked_engine(ContinuousEngine, arch, params, slots_budget=2,
                         attn_kernel="paged")
    eng.run_batch(reqs)
    eng.pool.check_invariants()
    eng.scheduler.check_invariants()
    assert tokens_of(reqs) == want
    jrep, jtokens = jax_chunked("gemma2-2b", SCARCE, slots_budget=2)
    assert jtokens == want
    rep = eng.report(1.0)
    for key in ("chunk_steps", "chunk_tokens", "decode_steps",
                "preemptions"):
        assert rep[key] == jrep[key], key
    assert all(m.alloc.n_live == 0 for m in eng.pool.maps.values())


# --------------------------------------------------------------------------
# scheduling policies
# --------------------------------------------------------------------------

def test_resume_cost_victim_matches_jax():
    """Base victim rule: with resume_cost, the slot whose continuation
    re-chunks the fewest tokens (ties: youngest admission); without,
    the youngest admission."""
    seq = {0: 1, 1: 2, 2: 3}
    for costs, want in (({0: 40, 1: 8, 2: 16}, 1),
                        ({0: 8, 1: 8, 2: 16}, 1),
                        (None, 2)):
        rc = None if costs is None else costs.__getitem__
        got = SchedulingPolicy().victim(
            [0, 1, 2], PolicyContext(admit_seq=seq, resume_cost=rc))
        jgot = JaxPolicy().victim(
            [0, 1, 2], JaxContext(admit_seq=seq, resume_cost=rc))
        assert got == jgot == want


def test_engine_hands_the_policy_a_resume_cost():
    """Under chunked admission the engine's context carries resume_cost
    = prompt + generated tokens of the slot (0 for a free slot), and the
    submit time of each request; without a controller it has none. The
    paged pool's warm-prefix probe rides along (none on a dense pool)."""
    _, _, arch, params = arch_pair("gemma2-2b")
    eng = chunked_engine(ContinuousEngine, arch, params)
    reqs = make_requests(Request, arch.cfg.vocab, [(7, 20), (11, 20)])
    for r in reqs:
        eng.submit(r)
    for _ in range(20):         # until both decode (the prompts chunked)
        if len(eng._decode_slots()) == 2:
            break
        eng.step()
    assert len(eng._decode_slots()) == 2
    ctx = eng._policy_ctx()
    for slot, req in eng.scheduler.active.items():
        assert ctx.resume_cost(slot) == (len(req.prompt)
                                         + len(eng._emitted[slot]))
        assert ctx.submit_t(req) == req.trace.submit_t
    assert ctx.resume_cost(2) == 0
    # the paged pool answers the warm-prefix probe; a dense pool has none
    for req in reqs:
        assert ctx.prefix_warm(req) == eng.pool.prefix_warm(
            eng._full_prompt(req), eng._plen(req), eng._padded_len(req))
    plain = ContinuousEngine(arch, params, max_batch=2, max_len=MAX_LEN)
    assert plain._policy_ctx().resume_cost is None
    dense = ContinuousEngine(arch, params, max_batch=2, max_len=MAX_LEN,
                             cache="dense")
    assert dense._policy_ctx().prefix_warm is None


def _traced(cls, trace_cls, submit_t):
    req = cls(prompt=np.zeros(3, np.int32), max_new_tokens=2)
    req.trace = trace_cls(submit_t=submit_t)
    return req


def test_arrival_deadline_matches_jax():
    """pick and victim of arrival-deadline equal JAX's on the same
    contexts: random submit times with ties, queues in ticket order with
    gaps, and continuations (a re-admitted request keeps its submit
    time, so its deadline, though its admission is the newest)."""
    rng = np.random.default_rng(0)
    pol = SchedulingPolicy.parse("arrival-deadline", slo_s=0.5)
    jpol = JaxPolicy.parse("arrival-deadline", slo_s=0.5)
    assert pol.name == jpol.name == "arrival-deadline"
    assert pol.slo_s == jpol.slo_s == 0.5
    for _ in range(200):
        n = int(rng.integers(1, 7))
        submits = rng.integers(0, 4, size=n).astype(float)
        tickets = sorted(rng.choice(50, size=n, replace=False).tolist())
        queues = [[(t, _traced(cls, tr, s)) for t, s in zip(tickets, submits)]
                  for cls, tr in ((Request, RequestTrace),
                                  (JaxRequest, JaxTrace))]
        assert (pol.pick(queues[0], PolicyContext(
                    submit_t=lambda r: r.trace.submit_t))
                == jpol.pick(queues[1], JaxContext(
                    submit_t=lambda r: r.trace.submit_t)))
        slots = sorted(rng.choice(8, size=n, replace=False).tolist())
        seq = {s: int(rng.integers(0, 20)) for s in slots}
        got = [p.victim(slots, ctx_cls(
                   admit_seq=seq, active=dict(zip(slots, (r for _, r in q))),
                   submit_t=lambda r: r.trace.submit_t))
               for p, ctx_cls, q in ((pol, PolicyContext, queues[0]),
                                     (jpol, JaxContext, queues[1]))]
        assert got[0] == got[1]
    # a continuation: admitted last, yet the earliest submit time, is not
    # the victim; the latest submit is
    early, late = (_traced(Request, RequestTrace, t) for t in (0.0, 5.0))
    ctx = PolicyContext(admit_seq={0: 9, 1: 1}, active={0: early, 1: late},
                        submit_t=lambda r: r.trace.submit_t)
    assert pol.victim([0, 1], ctx) == 1
    assert SchedulingPolicy().victim([0, 1], ctx) == 0
    from repro_torch.serving import PrefixAffinityPolicy
    assert isinstance(SchedulingPolicy.parse("prefix-affinity"),
                      PrefixAffinityPolicy)


def test_chunked_engine_goes_on_after_a_one_token_finalize():
    """A one-token request whose task finalizes and finishes while no
    other slot decodes leaves the engine with nothing active and nothing
    prefilling, and a queue. The port starts the next task in the next
    step (the tokens equal the whole-prompt paged run's); the JAX
    chunked engine raises "cannot fit an empty paged arena" there, as
    ROADMAP.md Queue 3 records."""
    jarch, jparams, arch, params = arch_pair("gemma2-2b")
    spec = [(7, 4), (11, 6), (21, 1), (9, 3), (11, 4)]
    reqs = make_requests(Request, arch.cfg.vocab, spec)
    ContinuousEngine(arch, params, max_batch=3, max_len=MAX_LEN,
                     policy="fp32", cache="paged", block_size=8,
                     prefill_bucket=8).run_batch(reqs)
    want = tokens_of(reqs)
    reqs = make_requests(Request, arch.cfg.vocab, spec)
    eng = chunked_engine(ContinuousEngine, arch, params)
    eng.run_batch(reqs)
    assert tokens_of(reqs) == want
    eng.scheduler.check_invariants()
    with pytest.raises(RuntimeError, match="cannot fit an empty paged"):
        chunked_engine(JaxEngine, jarch, jparams).run_batch(
            make_requests(JaxRequest, jarch.cfg.vocab, spec))


def test_chunked_insert_takes_the_window_tail_of_an_unclamped_cache():
    """A chunked task's cache keeps full-length sliding-window rows (64
    here, window 16): _src_rows equals JAX's on a grid that includes
    request caches longer than the ring, and inserting a 23-token
    prompt's task cache with share=False puts exactly its last 16 rows
    in the local layer's ring, as a whole-prompt insert does."""
    import torch
    from repro.serving.cache_pool import PagedCachePool as JaxPool
    from repro_torch.serving import PagedCachePool, pad_prompts
    for ring, cache_len, plen in itertools.product((16, 24, 48), (16, 48, 64),
                                                   (1, 7, 16, 23, 40)):
        padded = -(-plen // 8) * 8
        if padded >= cache_len and cache_len != ring:
            continue        # a request cache the engine never builds
        got = PagedCachePool._src_rows(None, ring, cache_len, plen, padded)
        want = JaxPool._src_rows(None, ring, cache_len, plen, padded)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
    _, _, arch, params = arch_pair("gemma2-2b")
    ctrl = AdmissionController(arch, params, chunk_budget=8,
                               prefill_len=64)
    prompt = np.random.default_rng(5).integers(5, 1000, 23).astype(np.int32)
    tokens, positions, _ = pad_prompts([prompt], 8)
    ctrl.start("req", 0, tokens, positions, plen=23, padded_len=24,
               resume_len=0, prompt=prompt)
    while not ctrl.task.finished:
        ctrl.advance(0)
    pool = PagedCachePool(arch, 2, 48, block_size=8, growth="lazy")
    pool.insert(ctrl.task.cache, 1, prompt=prompt, plen=23, padded_len=24,
                budget=4, share=False)
    assert pool.shared_hits == 0 and pool.prefix_misses == 0
    src = ctrl.task.cache["slots"][0]       # the local (windowed) layer
    m = pool.maps[0]
    assert m.ring_len == 16
    for p in range(23 - 16, 23):            # the window's tail
        r = p % 16
        blk, off = int(m.table[1, r // 8]), r % 8
        assert int(pool.cache["slots"][0]["pos"][0, blk, off]) == p
        torch.testing.assert_close(pool.cache["slots"][0]["k"][:, blk, off],
                                   src["k"][:, 0, 1 + p], rtol=0, atol=0)
    pool.check_invariants()
