"""The encoder-decoder serving family of the port: one ContinuousEngine
serves whisper-style requests with each encoder input's cross K/V in the
content-addressed block arena of EncDecCachePool.

  * tests/test_encdec_serving.py's eight claims, on the port's engine
    (JAX's one-compile pin becomes one step shape: every decode step
    sees the same (tokens, positions, cache) shapes);
  * greedy tokens equal the JAX engine's on the same weights and
    requests, shared and retained cross blocks included, and the block
    counters agree;
  * frames_key equals JAX's byte for byte, the synthetic stream is
    JAX's, the pool's insert is atomic, and the CLI serves whisper.

Reduced whisper-large-v3, the fp32 serving policy on both sides.
"""
import functools
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_arch as jreduced
from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import frames_key as jframes_key
from repro.serving import synthetic_encdec_requests as jrequests
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.serving import (ContinuousEngine, EncDecCachePool,
                                 NoBlocksError, Request, frames_key,
                                 synthetic_encdec_requests)

ARCH = "whisper-large-v3"


@functools.lru_cache(maxsize=None)
def _pair():
    """(JAX arch, JAX params, port arch, port params), reduced, the same
    weights on both sides."""
    ja, ta = jreduced(ARCH), tconfigs.reduced_arch(ARCH)
    jp = jax.jit(ja.init)(jax.random.PRNGKey(0))
    return ja, jp, ta, params_from_jax(ta.cfg, jax.tree.map(np.asarray, jp))


def _engine(**kw):
    _, _, arch, params = _pair()
    for k, v in dict(max_batch=4, max_len=32, prefill_bucket=8,
                     block_size=8, cache="paged", policy="fp32").items():
        kw.setdefault(k, v)
    return ContinuousEngine(arch, params, **kw)


def _requests(n, *, n_inputs=None, seed=3, prompt_len=6, new_tokens=8):
    cfg = _pair()[2].cfg
    return synthetic_encdec_requests(
        n, cfg.vocab, n_frames=cfg.n_frames, d_model=cfg.d_model,
        prompt_len=prompt_len, new_tokens=new_tokens, n_inputs=n_inputs,
        seed=seed)


def _record_shapes(eng):
    """Wrap the engine's decode step to record the shapes it is called
    with: the port's form of JAX's one-compile pin."""
    shapes, step = set(), eng._step

    def recorded(params, tokens, positions, cache, *rest):
        shapes.add((tuple(tokens.shape), tuple(positions.shape),
                    tuple((k, tuple(v.shape)) for k, v in sorted(
                        cache["cross"].items()))))
        return step(params, tokens, positions, cache, *rest)

    eng._step = recorded
    return shapes


# ---------------------------------------------------------------------------
# tests/test_encdec_serving.py's claims
# ---------------------------------------------------------------------------

def test_engine_serves_encdec_with_one_step_shape():
    eng = _engine()
    shapes = _record_shapes(eng)
    reqs = _requests(6, n_inputs=2)
    eng.run(reqs)
    assert len(eng.scheduler.completed) == 6
    for r in reqs:
        assert len(r.generated) == r.max_new_tokens
        assert (np.asarray(r.generated) >= 0).all()
    # varied prompts and budgets, admission churn over two waves of
    # slots: one decode-step shape
    assert len(shapes) == 1
    eng.pool.check_invariants()


def test_same_input_requests_share_encoder_blocks():
    """Two decodes of the same input share the encoder's cross blocks:
    mid-run the arena holds one refcount-2 chain, and draining leaves no
    block live."""
    eng = _engine()
    cfg = eng.arch.cfg
    frames = np.random.default_rng(11).standard_normal(
        (cfg.n_frames, cfg.d_model)).astype(np.float32)
    a = Request(prompt=np.arange(5, 11, dtype=np.int32), max_new_tokens=6,
                frames=frames)
    b = Request(prompt=np.arange(7, 13, dtype=np.int32), max_new_tokens=6,
                frames=frames.copy())      # same content, another array
    eng.submit(a)
    eng.submit(b)
    eng.step()                             # both admitted (4 free slots)
    m = eng.pool.map
    per_input = eng.pool.padded_frames // eng.pool.block_size
    shared = [bi for bi in range(1, m.alloc.n_blocks) if m.alloc.ref[bi] == 2]
    assert len(shared) == per_input, shared
    assert eng.pool.shared_hits >= per_input
    while eng.step():
        pass
    assert len(eng.scheduler.completed) == 2
    assert m.alloc.n_live == 0
    eng.pool.check_invariants()


def test_distinct_inputs_do_not_share():
    eng = _engine()
    for r in _requests(2, n_inputs=2, seed=5):
        eng.submit(r)
    eng.step()
    assert eng.pool.shared_hits == 0
    while eng.step():
        pass
    eng.pool.check_invariants()


def test_retained_cross_blocks_revive_across_waves():
    """Encoder blocks survive refcount 0 on the retained LRU and revive
    without a write when the same input returns in a later wave."""
    eng = _engine()
    shapes = _record_shapes(eng)
    eng.run(_requests(3, n_inputs=1, seed=9))
    hits_before = eng.pool.retained_hits
    eng.run(_requests(3, n_inputs=1, seed=9))    # the same frames
    assert eng.pool.retained_hits > hits_before
    assert len(shapes) == 1
    eng.pool.check_invariants()


def test_run_one_matches_pooled_engine():
    eng = _engine()
    shapes = _record_shapes(eng)
    pooled = _requests(5, n_inputs=2, seed=7)
    eng.run(pooled)
    assert len(shapes) == 1
    solo = _requests(5, n_inputs=2, seed=7)      # byte-identical
    for r in solo:
        eng.run_one(r)
    for p, s in zip(pooled, solo):
        np.testing.assert_array_equal(p.generated, s.generated)
        assert s.trace.done_t >= s.trace.admit_t > 0
    # the same decode step at batch 1: one more shape
    assert len(shapes) == 2


def test_encdec_requires_paged_cache():
    with pytest.raises(ValueError, match="cache='paged'"):
        _engine(cache="dense")


def test_encdec_rejects_scoring_task_and_decoder_only_features():
    _, _, arch, params = _pair()
    with pytest.raises(ValueError, match="bert arch"):
        _engine(task="score")
    with pytest.raises(ValueError, match="decoder-only"):
        _engine(chunk_budget=8)
    with pytest.raises(ValueError, match="decoder-only"):
        _engine(spec_draft=(arch, params))
    with pytest.raises(ValueError, match="decoder-only"):
        _engine(attn_kernel="paged")


def test_submit_requires_frames_of_the_configured_length():
    eng = _engine()
    cfg = eng.arch.cfg
    with pytest.raises(ValueError, match="frames"):
        eng.submit(Request(prompt=np.arange(5, 9, dtype=np.int32),
                           max_new_tokens=2))
    bad = np.zeros((cfg.n_frames + 1, cfg.d_model), np.float32)
    with pytest.raises(ValueError, match="frames"):
        eng.submit(Request(prompt=np.arange(5, 9, dtype=np.int32),
                           max_new_tokens=2, frames=bad))
    with pytest.raises(ValueError, match="frames"):
        eng.run_one(Request(prompt=np.arange(5, 9, dtype=np.int32),
                            max_new_tokens=2))


# ---------------------------------------------------------------------------
# against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("share", [True, False])
def test_tokens_match_jax_engine(share):
    """Two waves over two distinct inputs (shared blocks within a wave,
    retained ones revived across waves; with share_prefix=False neither,
    no block is content-keyed):
    greedy tokens and every block counter equal the JAX engine's, and
    the JAX engine's run_one tokens equal the port's."""
    ja, jp, _, _ = _pair()
    kw = dict(max_batch=3, max_len=32, prefill_bucket=8, block_size=8,
              cache="paged", policy="fp32", share_prefix=share)
    jeng = JaxEngine(ja, jp, **kw)
    teng = _engine(**kw)
    for seed in (4, 4):
        reqs = {}
        for name, eng, make in (("jax", jeng, jrequests),
                                ("port", teng, synthetic_encdec_requests)):
            reqs[name] = make(7, ja.cfg.vocab, n_frames=ja.cfg.n_frames,
                              d_model=ja.cfg.d_model, prompt_len=6,
                              new_tokens=8, n_inputs=2, seed=seed)
            eng.run(reqs[name])
        for j, t in zip(reqs["jax"], reqs["port"]):
            np.testing.assert_array_equal(t.generated, np.asarray(j.generated))
        jrep, trep = jeng.report(1.0), teng.report(1.0)
        for k in ("shared_block_hits", "retained_block_hits",
                  "prefix_misses", "decode_steps", "task"):
            assert trep[k] == jrep[k], k
    assert (trep["shared_block_hits"] > 0) == share
    assert (trep["retained_block_hits"] > 0) == share
    solo_j = jrequests(2, ja.cfg.vocab, n_frames=ja.cfg.n_frames,
                       d_model=ja.cfg.d_model, prompt_len=6, new_tokens=8,
                       seed=8)
    solo_t = _requests(2, seed=8)
    for j, t in zip(solo_j, solo_t):
        np.testing.assert_array_equal(teng.run_one(t).generated,
                                      np.asarray(jeng.run_one(j).generated))


def test_retained_lru_is_sized_in_decoder_rows_like_jax():
    """The engine sizes the cross pool's retained LRU as the decoder
    pool's, max_batch * (max_len // block_size) blocks, not in the cross
    blocks of an input: with 64 frames in blocks of 8 (8 blocks an input)
    and one slot of 16 rows, a drained input keeps 2 blocks warm, and
    the same input's next request revives those 2 and writes 6 afresh,
    in both engines."""
    import dataclasses
    ja, ta = jreduced(ARCH), tconfigs.reduced_arch(ARCH)
    ja = dataclasses.replace(ja, cfg=dataclasses.replace(ja.cfg,
                                                         n_frames=64))
    ta = dataclasses.replace(ta, cfg=dataclasses.replace(ta.cfg,
                                                         n_frames=64))
    jp = jax.jit(ja.init)(jax.random.PRNGKey(1))
    tp = params_from_jax(ta.cfg, jax.tree.map(np.asarray, jp))
    kw = dict(max_batch=1, max_len=16, block_size=8, policy="fp32")
    counts = []
    for eng, make in ((JaxEngine(ja, jp, **kw), jrequests),
                      (ContinuousEngine(ta, tp, **kw),
                       synthetic_encdec_requests)):
        assert eng.pool.map.retain_limit == 2
        got = []
        for _ in range(2):
            eng.run(make(1, ja.cfg.vocab, n_frames=64,
                         d_model=ja.cfg.d_model, prompt_len=4,
                         new_tokens=4, seed=6))
            got.append((eng.pool.retained_hits, eng.pool.prefix_misses,
                        eng.pool.shared_hits))
        counts.append(got)
    assert counts[0] == counts[1] == [(0, 8, 0), (2, 14, 2)]


def test_frames_key_and_stream_match_jax():
    rng = np.random.default_rng(2)
    for shape, padded in (((16, 128), 16), ((1500, 8), 1504)):
        frames = rng.standard_normal(shape).astype(np.float32)
        got, want = frames_key(frames, padded), jframes_key(frames, padded)
        assert got.dtype == want.dtype == np.int64
        assert got.tobytes() == want.tobytes()
    cfg = _pair()[0].cfg
    kw = dict(n_frames=cfg.n_frames, d_model=cfg.d_model, prompt_len=6,
              new_tokens=8, n_inputs=2, seed=1)
    for t, j in zip(synthetic_encdec_requests(5, cfg.vocab, **kw),
                    jrequests(5, cfg.vocab, **kw)):
        assert t.prompt.tobytes() == j.prompt.tobytes()
        assert t.frames.tobytes() == j.frames.tobytes()
        assert t.max_new_tokens == j.max_new_tokens


def test_pool_insert_is_atomic_on_no_blocks():
    """A cross arena of one input's blocks: a second distinct input
    raises NoBlocksError and leaves the map, the table and the arena as
    they were; the same input still shares."""
    _, _, arch, _ = _pair()
    pool = EncDecCachePool(arch, 2, 16, block_size=8, slots_budget=1)
    cfg = arch.cfg
    L, H, hd = cfg.n_layers, cfg.n_heads, cfg.head_dim
    req = arch.init_cache(1, 16)
    rng = np.random.default_rng(0)
    frames = [rng.standard_normal((cfg.n_frames, cfg.d_model)).astype(
        np.float32) for _ in range(2)]
    ck = torch.randn(L, cfg.n_frames, H, hd)
    pool.insert(req, 0, frames=frames[0], cross_k=ck, cross_v=ck)
    before = {n: t.clone() for n, t in pool.cache["cross"].items()}
    table = pool.map.table.copy()
    with pytest.raises(NoBlocksError):
        pool.insert(req, 1, frames=frames[1], cross_k=ck, cross_v=ck)
    np.testing.assert_array_equal(pool.map.table, table)
    for n, t in pool.cache["cross"].items():
        assert torch.equal(t, before[n]), n
    pool.check_invariants()
    pool.insert(req, 1, frames=frames[0].copy(), cross_k=ck, cross_v=ck)
    assert pool.shared_hits == pool.padded_frames // 8
    assert pool.admission_plan(frames[1]) == {"cross": 2}
    assert pool.free_blocks() == {"cross": 0}
    pool.evict(0)
    pool.evict(1)
    assert pool.map.alloc.n_live == 0 and pool.lengths().tolist() == [0, 0]
    pool.check_invariants()


def test_cli_serves_whisper_on_cpu(capsys):
    stats, done = tserve.main([
        "--device", "cpu", "--arch", ARCH, "--requests", "5",
        "--prompt-len", "8", "--new-tokens", "6", "--shared-inputs", "2",
        "--seed", "2"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["requests"] == 5 == len(done)
    assert report["tokens"] == sum(len(r.generated) for r in done) > 0
    assert report["task"] == "generate" and report["attn_kernel"] == "xla"
    assert stats["shared_block_hits"] > 0
