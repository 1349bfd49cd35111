"""The port's speculative draft-verify decoding, against itself and the
JAX package (the claims of tests/test_speculative.py, on reduced
gemma2-2b with the weights carried over by repro_torch.bridge).

  * exactness: static == dense == paged == speculative-paged greedy fp32
    tokens with a reject-heavy random draft, and the port's speculative
    engine (kernel path, its plain version on the CPU, and the gather
    path) emits the JAX speculative engine's tokens (attn_kernel="xla"
    there: the Pallas kernel fails on jax 0.9.0), greedy and sampled;
  * arenas after reject churn: positions equal to the JAX engine's on
    every block; K/V of valid rows within one bf16 ulp (the K/V
    projections round differently in torch and XLA); between the port's
    kernel and gather paths, layer-0 data blocks bit for bit;
  * the bf16 same-layout pair with the tie-stable argmax;
  * make_spec_pair: the JAX pair's params, acceptance 1.0, full blocks;
  * sampled streams survive reject churn and preemption unchanged;
  * wrap-time COW keeps prefix sharing across waves;
  * paged_layout's row margin, and the constructor's validation.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models.decoder import paged_layout as jax_paged_layout
from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import make_spec_pair as jax_make_spec_pair
from repro_torch.bridge import params_from_jax
from repro_torch.models.decoder import paged_layout
from repro_torch.serving import (ContinuousEngine, Request, ServeEngine,
                                 make_spec_pair)

MAX_LEN = 48
SSPEC = [(7, 4), (11, 6), (5, 1), (9, 3), (11, 4)]
SAMPLER = "temperature=0.8,top_k=20,seed=11"


def make_requests(cls, vocab, spec=SSPEC, seed=1, prefix=16,
                  prefix_seed=None):
    """tests/conftest.make_serving_requests, for either package."""
    rng = np.random.default_rng(
        [seed if prefix_seed is None else prefix_seed, 999])
    common = rng.integers(5, vocab, size=prefix).astype(np.int32)
    return [cls(prompt=np.concatenate([
                    common, np.random.default_rng([seed, i]).integers(
                        5, vocab, size=n).astype(np.int32)]),
                max_new_tokens=m) for i, (n, m) in enumerate(spec)]


def _tokens(reqs):
    return [r.generated.tolist() for r in reqs]


@pytest.fixture(scope="module")
def draft_pair(gemma_pair):
    """An independently seeded draft of the same config on both sides:
    its proposals are almost always rejected (the reject-churn case)."""
    jarch, _, tarch, _ = gemma_pair
    jdraft = jarch.init(jax.random.PRNGKey(7))
    return jdraft, params_from_jax(tarch.cfg,
                                   jax.tree.map(np.asarray, jdraft))


def spec_engine(arch, params, draft, cls=ContinuousEngine, **kw):
    base = dict(max_batch=3, max_len=MAX_LEN, cache="paged", block_size=8,
                prefill_bucket=8, spec_draft=draft, spec_k=4,
                policy="fp32")
    base.update(kw)
    return cls(arch, params, **base)


_jax_runs = {}


def jax_spec_run(gemma_pair, draft_pair, sampler):
    """The JAX speculative engine's run (memoized per sampler)."""
    if sampler not in _jax_runs:
        jarch, jparams, _, _ = gemma_pair
        reqs = make_requests(JaxRequest, jarch.cfg.vocab)
        eng = spec_engine(jarch, jparams, (jarch, draft_pair[0]),
                          cls=JaxEngine, attn_kernel="xla", sampler=sampler)
        eng.run_batch(reqs)
        _jax_runs[sampler] = (eng, reqs)
    return _jax_runs[sampler]


def test_spec_greedy_quad_fp32(gemma_pair, draft_pair):
    """static == dense == paged == speculative-paged in the port, greedy
    fp32, with a reject-heavy draft: every round rolls back."""
    _, _, arch, params = gemma_pair
    builders = [
        lambda: ServeEngine(arch, params, max_len=MAX_LEN, policy="fp32"),
        lambda: ContinuousEngine(arch, params, max_batch=2, max_len=MAX_LEN,
                                 cache="dense", prefill_bucket=8,
                                 policy="fp32"),
        lambda: ContinuousEngine(arch, params, max_batch=3, max_len=MAX_LEN,
                                 cache="paged", block_size=8,
                                 prefill_bucket=8, policy="fp32"),
        lambda: spec_engine(arch, params, (arch, draft_pair[1])),
    ]
    runs = []
    for build in builders:
        reqs = make_requests(Request, arch.cfg.vocab)
        eng = build()
        eng.run_batch(reqs)
        runs.append(_tokens(reqs))
    assert runs[1] == runs[0] and runs[2] == runs[0] and runs[3] == runs[0]
    spec = eng
    assert spec.spec_rounds > 0
    assert spec.accepted_tokens < spec.drafted_tokens
    spec.pool.check_invariants()


@pytest.mark.parametrize("sampler", [None, SAMPLER])
@pytest.mark.parametrize("attn_kernel", ["paged", "xla"])
def test_spec_engine_matches_jax_spec_engine(gemma_pair, draft_pair,
                                             attn_kernel, sampler):
    """Tokens and the round telemetry equal the JAX speculative engine's;
    after the reject churn the positions of every arena block equal the
    JAX engine's, and K/V of every valid row agree within one bf16 ulp
    (the padding rows of a round: the JAX gather path parks them in the
    null block's row 0, the kernel writes nothing; the null block's
    positions stay -1 on both)."""
    _, _, arch, params = gemma_pair
    jeng, jreqs = jax_spec_run(gemma_pair, draft_pair, sampler)
    reqs = make_requests(Request, arch.cfg.vocab)
    eng = spec_engine(arch, params, (arch, draft_pair[1]),
                      attn_kernel=attn_kernel, sampler=sampler)
    eng.run_batch(reqs)
    assert _tokens(reqs) == _tokens(jreqs)
    jrep, rep = jeng.report(1.0), eng.report(1.0)
    for key in ("spec_rounds", "drafted_tokens", "accepted_tokens",
                "decode_steps", "shared_block_hits"):
        assert rep[key] == jrep[key], key
    assert rep["accepted_tokens"] < rep["drafted_tokens"]
    for si in eng.pool.maps:
        ja = jax.tree.map(np.asarray, jeng.pool.cache["slots"][si])
        ta = eng.pool.cache["slots"][si]
        np.testing.assert_array_equal(ta["pos"].numpy(), ja["pos"])
        valid = ja["pos"] >= 0
        for part in ("k", "v"):
            np.testing.assert_allclose(
                ta[part].float().numpy()[valid],
                ja[part].astype(np.float32)[valid], rtol=8e-3, atol=2e-4,
                err_msg=f"slot-type {si} {part}")
    eng.pool.check_invariants()
    assert all(m.alloc.n_live == 0 for m in eng.pool.maps.values())


def test_spec_kernel_and_gather_paths_agree_on_arenas(gemma_pair,
                                                      draft_pair):
    """Reject churn on the kernel path (its plain version here) against
    the gather path, both in the port: equal tokens, equal positions on
    every block, layer-0 K/V data blocks bit for bit (same projections;
    an addressing fault of the fused write would show here), deeper
    valid rows within one bf16 ulp (summation order)."""
    _, _, arch, params = gemma_pair
    engines = {}
    for kern in ("paged", "xla"):
        reqs = make_requests(Request, arch.cfg.vocab)
        eng = spec_engine(arch, params, (arch, draft_pair[1]),
                          attn_kernel=kern)
        eng.run_batch(reqs)
        engines[kern] = (eng, _tokens(reqs))
    assert engines["paged"][1] == engines["xla"][1]
    ep, ex = engines["paged"][0], engines["xla"][0]
    for si in ep.pool.maps:
        pa, xa = ep.pool.cache["slots"][si], ex.pool.cache["slots"][si]
        assert torch.equal(pa["pos"], xa["pos"])
        valid = xa["pos"] >= 0
        for part in ("k", "v"):
            assert torch.equal(pa[part][0, 1:], xa[part][0, 1:])
            torch.testing.assert_close(pa[part][valid].float(),
                                       xa[part][valid].float(),
                                       rtol=8e-3, atol=2e-4)


def test_spec_bf16_same_layout_pair(gemma_pair, draft_pair):
    """bf16 paged vs speculative-paged under the tie-stable argmax: the
    row-margined rings change reduction shapes, the one-ulp band keeps
    the picks."""
    _, _, arch, params = gemma_pair
    sampler = "temperature=0,stable=1"
    a = make_requests(Request, arch.cfg.vocab)
    ContinuousEngine(arch, params, max_batch=3, max_len=MAX_LEN,
                     cache="paged", block_size=8, prefill_bucket=8,
                     policy="bf16", sampler=sampler).run(a)
    b = make_requests(Request, arch.cfg.vocab)
    eng = spec_engine(arch, params, (arch, draft_pair[1]), policy="bf16",
                      sampler=sampler)
    eng.run(b)
    assert _tokens(a) == _tokens(b)
    assert eng.report(1.0)["nonfinite_logit_steps"] == 0


@pytest.fixture(scope="module")
def two_period_pair():
    """Reduced gemma2-2b with 2 periods (4 layers): make_spec_pair
    needs a period to cut."""
    from repro.configs import reduced_arch
    from repro_torch import configs as tconfigs
    jarch = reduced_arch("gemma2-2b")
    jarch = dataclasses.replace(jarch, cfg=dataclasses.replace(
        jarch.cfg, n_layers=4))
    tarch = tconfigs.reduced_arch("gemma2-2b")
    tarch = dataclasses.replace(tarch, cfg=dataclasses.replace(
        tarch.cfg, n_layers=4))
    jparams = jarch.init(jax.random.PRNGKey(3))
    return jarch, jparams, tarch, params_from_jax(
        tarch.cfg, jax.tree.map(np.asarray, jparams))


def test_spec_full_acceptance_pair_emits_blocks(two_period_pair):
    """make_spec_pair gives the JAX pair's params; its doctored target
    accepts every proposal, so each round emits a full spec_k block and
    the rounds are fewer than the plain engine's steps."""
    jarch, jparams, arch, params = two_period_pair
    jt, jda, jdp = jax_make_spec_pair(jarch, jparams)
    tgt, draft_arch, draft_params = make_spec_pair(arch, params)
    assert draft_arch.cfg.n_layers == jda.cfg.n_layers == 2
    for mine, theirs in ((tgt, params_from_jax(arch.cfg, jax.tree.map(
            np.asarray, jt))), (draft_params, params_from_jax(
            draft_arch.cfg, jax.tree.map(np.asarray, jdp)))):
        flat = jax.tree_util.tree_leaves_with_path(theirs)
        for path, leaf in flat:
            node = mine
            for k in path:
                node = node[k.key]
            assert torch.equal(node, leaf), path
    a = make_requests(Request, arch.cfg.vocab)
    plain = ContinuousEngine(arch, tgt, max_batch=3, max_len=MAX_LEN,
                             cache="paged", block_size=8, prefill_bucket=8)
    plain.run(a)
    b = make_requests(Request, arch.cfg.vocab)
    spec = spec_engine(arch, tgt, (draft_arch, draft_params), policy=None)
    spec.run(b)
    assert _tokens(a) == _tokens(b)
    assert spec.report(1.0)["acceptance_rate"] == 1.0
    assert spec.steps_run < plain.steps_run
    spec.pool.check_invariants()


def _straight_line_sampled(arch, params, spec=SSPEC, prefix=16):
    reqs = make_requests(Request, arch.cfg.vocab, spec=spec, prefix=prefix)
    ContinuousEngine(arch, params, max_batch=2, max_len=MAX_LEN,
                     cache="dense", prefill_bucket=8, policy="fp32",
                     sampler=SAMPLER).run(reqs)
    return _tokens(reqs)


def test_spec_sampled_stream_survives_reject_churn(gemma_pair, draft_pair):
    """Reject-heavy speculative sampling == straight-line sampling: row i
    draws with the key of token emitted + i, so a rollback neither reuses
    nor skips a key."""
    _, _, arch, params = gemma_pair
    base = _straight_line_sampled(arch, params)
    reqs = make_requests(Request, arch.cfg.vocab)
    eng = spec_engine(arch, params, (arch, draft_pair[1]), sampler=SAMPLER)
    eng.run(reqs)
    assert eng.accepted_tokens < eng.drafted_tokens
    assert _tokens(reqs) == base


def test_preempted_sampled_stream_matches_straight_line(gemma_pair):
    """A one-slot arena under four slots forces mid-decode preemptions;
    the continuation prefill resumes the sampled stream at the same token
    indices."""
    _, _, arch, params = gemma_pair
    pressure = [(8, 20), (8, 18), (8, 16)]
    base = _straight_line_sampled(arch, params, spec=pressure, prefix=0)
    reqs = make_requests(Request, arch.cfg.vocab, spec=pressure, prefix=0)
    eng = ContinuousEngine(arch, params, max_batch=4, max_len=MAX_LEN,
                           cache="paged", block_size=8, prefill_bucket=8,
                           policy="fp32", sampler=SAMPLER, slots_budget=1,
                           share_prefix=False)
    eng.run(reqs)
    assert eng.preemptions > 0
    assert _tokens(reqs) == base


def test_wrap_cow_preserves_prefix_sharing_across_waves(gemma_pair):
    """The reduced sliding window is 16 rows: a 16-token shared prompt
    fills the window ring, so the first decode token wraps onto the
    shared prompt blocks. Wrap-time COW gives the writer a private copy
    and keeps the originals registered, so a second wave still shares or
    revives the prefix, and every stream equals its solo run."""
    _, _, arch, params = gemma_pair
    assert arch.cfg.sliding_window == 16

    def wave(seed):
        return make_requests(Request, arch.cfg.vocab, spec=[(2, 6), (3, 6)],
                             seed=seed, prefix=16, prefix_seed=99)

    solo_eng = ContinuousEngine(arch, params, max_batch=1, max_len=MAX_LEN,
                                cache="dense", prefill_bucket=8)
    solos = []
    for seed in (1, 2):
        s = wave(seed)
        solo_eng.run(s)
        solos.extend(_tokens(s))
    eng = ContinuousEngine(arch, params, max_batch=2, max_len=MAX_LEN,
                           cache="paged", block_size=8, prefill_bucket=8,
                           retain_blocks=8)
    w1 = wave(1)
    eng.run(w1)
    assert eng.pool.shared_hits > 0
    hits1 = eng.pool.shared_hits + eng.pool.retained_hits
    w2 = wave(2)
    eng.run(w2)
    assert eng.pool.shared_hits + eng.pool.retained_hits > hits1
    assert _tokens(w1 + w2) == solos
    eng.pool.check_invariants()


@pytest.mark.parametrize("max_len,block,margin", [
    (48, 8, 0), (48, 8, 3), (48, 8, 8), (48, 8, 9), (64, 16, 3),
    (4096, 16, 15)])
def test_paged_layout_row_margin_matches_jax(gemma_pair, max_len, block,
                                             margin):
    """Every ring widens by the margin rounded up to whole blocks."""
    jarch, _, tarch, _ = gemma_pair
    for jcfg, tcfg in ((jarch.cfg, tarch.cfg),
                       (dataclasses.replace(jarch.cfg, sliding_window=4096),
                        dataclasses.replace(tarch.cfg, sliding_window=4096))):
        assert paged_layout(tcfg, max_len, block, margin) == \
            jax_paged_layout(jcfg, max_len, block, margin)


def test_spec_validation_errors(gemma_pair, draft_pair):
    _, _, arch, params = gemma_pair
    draft = (arch, draft_pair[1])
    with pytest.raises(ValueError, match="spec_k"):
        spec_engine(arch, params, draft, spec_k=1)
    with pytest.raises(ValueError, match="paged"):
        spec_engine(arch, params, draft, cache="dense")
    hybrid = dataclasses.replace(arch, cfg=dataclasses.replace(
        arch.cfg, superblock=(("mamba", "mlp"), ("attn", "mlp"))))
    with pytest.raises(ValueError, match="attention-only"):
        spec_engine(hybrid, params, (hybrid, params))
    small = dataclasses.replace(arch, cfg=dataclasses.replace(
        arch.cfg, vocab=512))
    with pytest.raises(ValueError, match="vocab"):
        spec_engine(arch, params, (small, params))
    # K8 folds at most block_size new rows: a wider verify is flagged at
    # construction (on CUDA ensure_kernel_fit raises there instead)
    eng = spec_engine(arch, params, draft, attn_kernel="paged", spec_k=9)
    assert any("S=9" in p for p in eng.pool.tile_problems)
    assert not spec_engine(arch, params, draft, attn_kernel="paged",
                           spec_k=8).pool.tile_problems
