"""BERT scoring and embedding served by the port: bert_serve_outputs
against the JAX package, and the engine's score/embed family.

  * bert_serve_outputs and the positions form of bert_encode against the
    JAX package on left-padded rows: masked-LM ids equal, pooled vectors
    and hidden states within 1e-5 (fp32 compute on both sides); a
    left-padded row equals the same row unpadded;
  * tests/test_bert_scoring.py's eight claims on the port's engine (JAX's
    one-compile pins become one forward shape);
  * the engine's ids and embeddings against the JAX engine's on the same
    weights and requests (fp32 policy), the synthetic stream equal to
    JAX's, and the CLI's --task score|embed.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_arch as jreduced
from repro.models import bert as jbert
from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import synthetic_scoring_requests as jrequests
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.models import bert as tbert
from repro_torch.serving import (ContinuousEngine, Request,
                                 synthetic_scoring_requests)

ARCH = "bert-large"
F32 = dict(rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _pair(fp32: bool = False):
    """(JAX arch, JAX params, port arch, port params), reduced, the same
    weights on both sides; fp32=True sets fp32 compute on both."""
    ja, ta = jreduced(ARCH), tconfigs.reduced_arch(ARCH)
    if fp32:
        ja = dataclasses.replace(ja, cfg=dataclasses.replace(
            ja.cfg, compute_dtype=jnp.float32))
        ta = dataclasses.replace(ta, cfg=dataclasses.replace(
            ta.cfg, compute_dtype=torch.float32))
    jp = jax.jit(ja.init)(jax.random.PRNGKey(0))
    return ja, jp, ta, params_from_jax(ta.cfg, jax.tree.map(np.asarray, jp))


def _engine(task="score", **kw):
    _, _, arch, params = _pair()
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_len", 16)
    return ContinuousEngine(arch, params, task=task, **kw)


def _requests(n, *, seed=2, prompt_len=12):
    return synthetic_scoring_requests(n, _pair()[2].cfg.vocab,
                                      prompt_len=prompt_len, seed=seed)


def _record_shapes(eng):
    """Wrap the engine's scoring forward to record its input shapes."""
    shapes, score = set(), eng._score

    def recorded(params, tokens, positions):
        shapes.add((tuple(tokens.shape), tuple(positions.shape)))
        return score(params, tokens, positions)

    eng._score = recorded
    return shapes


def _case(seed, B=3, S=10, pads=(0, 3, 9)):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(5, 512, size=(B, S)).astype(np.int32)
    positions = np.stack([np.arange(S) - p for p in pads]).astype(np.int32)
    return tokens, positions


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_serve_outputs_match_jax():
    """Left-padded rows (no pad, 3 pads, a one-token row): ids equal, the
    pooled [CLS] vector and the hidden states within 1e-5."""
    ja, jp, ta, tp = _pair(fp32=True)
    tokens, positions = _case(0)
    jids, jpool = jbert.bert_serve_outputs(jp, ja.cfg, tokens, positions)
    tids, tpool = ta.score(tp, torch.from_numpy(tokens),
                           torch.from_numpy(positions))
    assert tids.dtype == torch.int32 and tpool.shape == (3, 128)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), **F32)
    jh = jbert.bert_encode(jp, ja.cfg, tokens, positions=positions)
    th = tbert.bert_encode(tp, ta.cfg, torch.from_numpy(tokens),
                           positions=torch.from_numpy(positions))
    valid = positions >= 0
    np.testing.assert_allclose(th.detach().numpy()[valid],
                               np.asarray(jh)[valid], **F32)


def test_left_padded_row_equals_unpadded():
    _, _, ta, tp = _pair(fp32=True)
    tokens, positions = _case(1)
    t = torch.from_numpy
    ids, pooled = ta.score(tp, t(tokens), t(positions))
    alone_ids, alone = ta.score(tp, t(tokens[1:2, 3:]), t(positions[1:2, 3:]))
    np.testing.assert_array_equal(ids[1, 3:].numpy(), alone_ids[0].numpy())
    np.testing.assert_allclose(pooled[1].numpy(), alone[0].numpy(), **F32)


def test_score_is_bert_only():
    for name in ("gemma2-2b", "whisper-large-v3"):
        arch = tconfigs.reduced_arch(name)
        with pytest.raises(ValueError, match="has no scoring forward"):
            arch.score(None, None, None)
        with pytest.raises(ValueError, match="has no scoring forward"):
            jreduced(name).score(None, None, None)


# ---------------------------------------------------------------------------
# tests/test_bert_scoring.py's claims
# ---------------------------------------------------------------------------

def test_scoring_completes_all_requests_with_one_forward_shape():
    eng = _engine()
    shapes = _record_shapes(eng)
    reqs = _requests(7)                    # a full batch and a short one
    eng.run(reqs)
    assert len(eng.scheduler.completed) == 7
    for r in reqs:
        assert len(r.generated) == len(r.prompt)   # MLM ids, valid tail
        assert r.embedding.shape == (eng.arch.cfg.d_model,)
        assert r.embedding.dtype == np.float32
    assert shapes == {((4, 16), (4, 16))}
    assert eng.report(1.0)["decode_steps"] == 2
    eng.scheduler.check_invariants()


def test_scoring_admits_in_policy_order():
    """fifo: the first max_batch submissions finish in the first step,
    the rest in the second (scoring slots free at completion)."""
    eng = _engine()
    reqs = _requests(6, seed=4)
    for r in reqs:
        eng.submit(r)
    eng.step()
    assert [r.rid for r in eng.scheduler.completed] == \
        [r.rid for r in reqs[:4]]
    eng.step()
    assert [r.rid for r in eng.scheduler.completed] == [r.rid for r in reqs]
    assert not eng.scheduler.has_work


def test_embed_task_returns_embedding_only():
    eng = _engine(task="embed")
    reqs = _requests(3, seed=6)
    eng.run(reqs)
    for r in reqs:
        assert len(r.generated) == 0
        assert r.embedding.shape == (eng.arch.cfg.d_model,)
    assert eng.report(1.0)["task"] == "embed"


def test_run_one_matches_batched_scoring():
    eng = _engine()
    shapes = _record_shapes(eng)
    batched = _requests(6, seed=8)
    eng.run(batched)
    solo = _requests(6, seed=8)            # byte-identical
    for r in solo:
        eng.run_one(r)
    for b, s in zip(batched, solo):
        np.testing.assert_array_equal(b.generated, s.generated)
        np.testing.assert_allclose(s.embedding, b.embedding, **F32)
    assert shapes == {((4, 16), (4, 16)), ((1, 16), (1, 16))}


def test_run_one_embed_matches_batched():
    eng = _engine(task="embed")
    batched = _requests(3, seed=10)
    eng.run(batched)
    solo = _requests(3, seed=10)
    for r in solo:
        eng.run_one(r)
    for b, s in zip(batched, solo):
        np.testing.assert_allclose(s.embedding, b.embedding, **F32)
        assert len(s.generated) == 0


def test_bert_arch_rejects_generate_task():
    _, _, arch, params = _pair()
    with pytest.raises(ValueError, match="task='score'"):
        ContinuousEngine(arch, params, task="generate")


def test_decoder_arch_rejects_scoring_task():
    arch = tconfigs.reduced_arch("gemma2-2b")
    with pytest.raises(ValueError, match="bert arch"):
        ContinuousEngine(arch, arch.init(None), task="score")
    with pytest.raises(ValueError, match="task must be"):
        ContinuousEngine(arch, arch.init(None), task="classify")


def test_bert_rejects_decoder_only_features_and_long_prompts():
    _, _, arch, params = _pair()
    with pytest.raises(ValueError, match="decoder-only"):
        _engine(chunk_budget=8)
    with pytest.raises(ValueError, match="position table"):
        _engine(max_len=arch.cfg.max_pos + 1)
    eng = _engine()
    long = Request(prompt=np.arange(5, 5 + eng.score_len + 1,
                                    dtype=np.int32), max_new_tokens=1)
    with pytest.raises(ValueError, match="scoring prompt length"):
        eng.submit(long)
    with pytest.raises(ValueError, match="scoring prompt length"):
        eng.run_one(long)


# ---------------------------------------------------------------------------
# against the JAX engine, the stream, the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("task", ["score", "embed"])
def test_engine_matches_jax_engine(task):
    """7 requests (two forwards, the second short) on the fp32 policy:
    ids equal and embeddings within 1e-5 of the JAX engine's, and the
    same for run_one."""
    ja, jp, ta, tp = _pair()
    kw = dict(max_batch=4, max_len=16, policy="fp32", task=task)
    jeng, teng = JaxEngine(ja, jp, **kw), ContinuousEngine(ta, tp, **kw)
    jr = jrequests(7, ja.cfg.vocab, prompt_len=12, seed=3)
    tr = _requests(7, seed=3)
    jeng.run(jr)
    teng.run(tr)
    jr.append(jeng.run_one(jrequests(1, ja.cfg.vocab, prompt_len=12,
                                     seed=5)[0]))
    tr.append(teng.run_one(_requests(1, seed=5)[0]))
    for j, t in zip(jr, tr):
        np.testing.assert_array_equal(t.generated, np.asarray(j.generated))
        np.testing.assert_allclose(t.embedding, np.asarray(j.embedding),
                                   **F32)
    assert teng.report(1.0)["decode_steps"] == \
        jeng.report(1.0)["decode_steps"] == 2


def test_scoring_stream_matches_jax():
    for t, j in zip(synthetic_scoring_requests(6, 512, prompt_len=20,
                                               seed=7),
                    jrequests(6, 512, prompt_len=20, seed=7)):
        assert t.prompt.tobytes() == j.prompt.tobytes()
        assert t.max_new_tokens == j.max_new_tokens == 1


@pytest.mark.parametrize("task", ["score", "embed"])
def test_cli_scores_bert_on_cpu(capsys, task):
    stats, done = tserve.main([
        "--device", "cpu", "--arch", ARCH, "--task", task, "--requests",
        "6", "--prompt-len", "16", "--seed", "1"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["requests"] == 6 == len(done)
    assert report["task"] == task == stats["task"]
    assert all(r.embedding.shape == (128,) for r in done)
    want = sum(len(r.prompt) for r in done) if task == "score" else 0
    assert report["tokens"] == want
