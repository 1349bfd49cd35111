"""MoE, Mamba-2 and hybrid decoders served by the port, against the JAX
package's engines, and fp16 serving.

  * reduced mamba2-130m and granite-moe-3b-a800m through every engine
    kind (static; continuous on the dense pool; on the paged pool with
    the kernel path, its plain version here, and with the gather;
    chunked prefill), each held to its own JAX counterpart on the
    request mix of tests/test_serving_engine.py (SPEC): greedy tokens
    equal, fp32 policy on both sides;
  * reduced jamba-1.5-large-398b (one attention slot, seven Mamba slots,
    dropless MoE) on the paged pool with the kernel path beside its
    slot-resident Mamba state: tokens equal the JAX attn_kernel="xla"
    engine's (the port's form of tests/test_paged_cache.py:326, whose
    Pallas run fails on jax 0.9.0);
  * the JAX granite static / continuous parting: neither engine is at
    fault (see test_granite_parting_is_bf16_rounding_not_a_fault);
  * the pools' slot-resident state and a pool with no arena (mamba2);
  * --precision fp16 through the port's CLI against the JAX CLI with the
    same flags and weights, and the new --arch values through the CLI.
"""
import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_arch as jreduced
from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import ServeEngine as JaxStatic
from repro.serving import apply_serving_policy as jax_serving_policy
from repro.models import decoder as jdec
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.models import decoder as tdec
from repro_torch.serving import (ContinuousEngine, Request, ServeEngine,
                                 apply_serving_policy)

# tests/test_serving_engine.py's request mix: (prompt_len, max_new_tokens)
SPEC = [(7, 4), (11, 6), (5, 1), (9, 3), (11, 4)]
MAX_LEN = 48


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(JAX arch, JAX params, port arch, port params), reduced, the same
    weights on both sides (the JAX init, carried by the bridge)."""
    ja, ta = jreduced(name), tconfigs.reduced_arch(name)
    jp = jax.jit(ja.init)(jax.random.PRNGKey(0))
    return ja, jp, ta, params_from_jax(ta.cfg, jax.tree.map(np.asarray, jp))


def _prompts(vocab, spec=SPEC, seed=1):
    """tests/conftest.py:make_serving_requests's prompts (seeded per
    request index)."""
    return [(np.random.default_rng([seed, i]).integers(
        5, vocab, size=n).astype(np.int32), m)
        for i, (n, m) in enumerate(spec)]


def _requests(cls, vocab, spec=SPEC):
    return [cls(prompt=p.copy(), max_new_tokens=m)
            for p, m in _prompts(vocab, spec)]


# engine kind -> (constructor kwargs, JAX counterpart's kwargs)
KINDS = {
    "static": None,
    "dense": (dict(cache="dense", prefill_bucket=8),
              dict(cache="dense", prefill_bucket=8)),
    "paged_kernel": (dict(cache="paged", attn_kernel="paged", block_size=8,
                          prefill_bucket=8),
                     dict(cache="paged", attn_kernel="xla", block_size=8,
                          prefill_bucket=8)),
    "paged_xla": (dict(cache="paged", attn_kernel="xla", block_size=8,
                       prefill_bucket=8),
                  dict(cache="paged", attn_kernel="xla", block_size=8,
                       prefill_bucket=8)),
    "chunked": (dict(cache="paged", attn_kernel="paged", block_size=8,
                     chunk_budget=32),
                dict(cache="paged", attn_kernel="xla", block_size=8,
                     chunk_budget=32)),
}


@functools.lru_cache(maxsize=None)
def _jax_tokens(name, kind, policy="fp32"):
    ja, jp, _, _ = _pair(name)
    reqs = _requests(JaxRequest, ja.cfg.vocab)
    if kind == "static":
        JaxStatic(ja, jp, max_len=MAX_LEN, policy=policy).run_batch(reqs)
    else:
        JaxEngine(ja, jp, max_batch=2, max_len=MAX_LEN, policy=policy,
                  **KINDS[kind][1]).run_batch(reqs)
    return [r.generated.tolist() for r in reqs]


def _port_engine(name, kind, policy="fp32"):
    _, _, ta, tp = _pair(name)
    if kind == "static":
        return ServeEngine(ta, tp, max_len=MAX_LEN, policy=policy)
    return ContinuousEngine(ta, tp, max_batch=2, max_len=MAX_LEN,
                            policy=policy, **KINDS[kind][0])


def _port_tokens(engine, vocab):
    reqs = _requests(Request, vocab)
    engine.run_batch(reqs)
    return [r.generated.tolist() for r in reqs]


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("name", ["mamba2-130m", "granite-moe-3b-a800m"])
def test_engine_tokens_match_jax_engine(name, kind):
    """Each port engine's greedy tokens equal its JAX counterpart's
    (max_batch 2 < 5 requests: admission, slot reuse and the Mamba
    state's insert and blanking are on the path)."""
    eng = _port_engine(name, kind)
    got = _port_tokens(eng, eng.arch.cfg.vocab)
    assert got == _jax_tokens(name, kind)
    assert [len(t) for t in got] == [m for _, m in SPEC]
    if kind != "static":
        assert eng.report(1.0)["nonfinite_logit_steps"] == 0
    if kind == "chunked":
        assert eng.report(1.0)["chunk_steps"] > 0
    if eng.arch.cfg.n_experts:       # served dropless
        assert eng.arch.cfg.capacity_factor == eng.arch.cfg.n_experts


@pytest.mark.parametrize("kernel", ["paged", "xla"])
def test_jamba_paged_pool_matches_jax_xla_engine(kernel):
    """Reduced jamba on the paged pool, with the kernel path and with the
    gather: the attention slot paged, the seven Mamba slots' state
    slot-resident, MoE dropless; tokens equal the JAX xla engine's, with
    a 16-token shared prefix (the attention blocks shared, the state
    not)."""
    ja, jp, ta, tp = _pair("jamba-1.5-large-398b")
    prefix = np.random.default_rng(9).integers(5, ja.cfg.vocab, 16)

    def reqs(cls):
        return [cls(prompt=np.concatenate([prefix, p]).astype(np.int32),
                    max_new_tokens=m)
                for p, m in _prompts(ja.cfg.vocab, SPEC)]

    kw = dict(max_batch=2, max_len=64, policy="fp32", cache="paged",
              block_size=8, prefill_bucket=8)
    jr = reqs(JaxRequest)
    JaxEngine(ja, jp, attn_kernel="xla", **kw).run_batch(jr)
    eng = ContinuousEngine(ta, tp, attn_kernel=kernel, **kw)
    tr = reqs(Request)
    eng.run_batch(tr)
    assert [r.generated.tolist() for r in tr] == [
        r.generated.tolist() for r in jr]
    pool = eng.pool
    assert sorted(pool.maps) == [0]
    assert pool._mamba_slots == tuple(range(1, 8))
    assert pool.shared_hits > 0
    pool.check_invariants()
    assert all(m.alloc.n_live == 0 for m in pool.maps.values())
    # every slot evicted: the state is blank again
    for si in pool._mamba_slots:
        assert not pool.cache["slots"][si]["ssm"].any()


def test_mamba_pool_holds_no_arena():
    """mamba2's paged pool: no attention slot, so no block map, no arena,
    no table on the device and no kernel layout check, and admission
    always fits; the engine still serves with --attn-kernel paged."""
    eng = _port_engine("mamba2-130m", "paged_kernel")
    pool = eng.pool
    assert pool.maps == {} and pool.tile_problems == []
    assert pool.device_tables() == (None,)
    assert set(pool.cache["slots"][0]) == {"ssm", "conv"}
    assert pool.cache["slots"][0]["ssm"].dtype == torch.float32
    assert pool.admissible_blocks() == {}


def test_state_insert_and_evict_in_both_pools():
    """A prefilled request's SSM state and conv tail land in the slot's
    row (and nowhere else); eviction blanks that row."""
    _, _, ta, tp = _pair("jamba-1.5-large-398b")
    arch, params = apply_serving_policy(ta, tp, "fp32")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        5, 1000, (1, 16)).astype(np.int32))
    for eng_kind in ("dense", "paged_xla"):
        eng = _port_engine("jamba-1.5-large-398b", eng_kind)
        _, req = arch.prefill(params, {"tokens": toks},
                              cache_len=eng._prefill_len,
                              positions=torch.arange(16)[None])
        pool = eng.pool
        # both pools take the Mamba slots from the superblock
        assert pool._mamba_slots == tuple(range(1, 8))
        if eng.paged:
            pool.insert(req, 1, prompt=toks[0].numpy(), plen=16,
                        padded_len=16, budget=4)
        else:
            pool.insert(req, 1)
        for si in range(1, 8):
            for k in ("ssm", "conv"):
                got = pool.cache["slots"][si][k]
                assert torch.equal(got[:, 1], req["slots"][si][k][:, 0])
                assert not got[:, 0].any()
        pool.evict(1)
        for si in range(1, 8):
            assert not pool.cache["slots"][si]["ssm"].any()
            assert not pool.cache["slots"][si]["conv"].any()


def _greedy_by_full_forward(arch, params, prompt, n, jax_side):
    """Greedy decoding by a full-sequence forward with no cache, the
    whole sequence recomputed for every token."""
    toks = list(prompt)
    for _ in range(n):
        if jax_side:
            logits, _, _ = jdec.decoder_apply(
                params, arch.cfg, jnp.asarray([toks], jnp.int32))
            toks.append(int(np.argmax(np.asarray(logits[0, -1]))))
        else:
            logits, _, _ = tdec.decoder_apply(
                params, arch.cfg, torch.tensor([toks], dtype=torch.int32))
            toks.append(int(torch.argmax(logits[0, -1])))
    return toks[len(prompt):]


def test_granite_parting_is_bf16_rounding_not_a_fault():
    """tests/test_serving_engine.py::test_continuous_matches_static_fp32
    [granite-moe-3b-a800m] runs with policy None: fp32 params but the
    config's default bf16 compute. There the JAX static and continuous
    engines part at request 3's second token, where the two best fp32
    logits lie 0.0033 apart (under a bf16 step at that size): the batch
    shapes (5 rows vs 2) round differently. Neither engine is at fault:
    with fp32 compute (the fp32 policy) both JAX engines, both of the
    port's, and greedy decoding by a full forward with no cache (each
    package's) give the same tokens."""
    ja, jp, ta, tp = _pair("granite-moe-3b-a800m")
    # the reference's parting, as that test runs it (policy None)
    assert _jax_tokens("granite-moe-3b-a800m", "static", None)[3] != \
        _jax_tokens("granite-moe-3b-a800m", "dense", None)[3]
    jarch, jparams = jax_serving_policy(ja, jp, "fp32")
    tarch, tparams = apply_serving_policy(ta, tp, "fp32")
    for i, (prompt, m) in enumerate(_prompts(ja.cfg.vocab)):
        want = _greedy_by_full_forward(jarch, jparams, prompt, m, True)
        assert _greedy_by_full_forward(tarch, tparams, prompt, m,
                                       False) == want
        for kind in ("static", "dense", "paged_xla"):
            assert _jax_tokens("granite-moe-3b-a800m", kind)[i] == want
        for kind in ("static", "dense"):
            eng = _port_engine("granite-moe-3b-a800m", kind)
            assert _port_tokens(eng, ta.cfg.vocab)[i] == want


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

FP16_ARGV = ["--requests", "4", "--prompt-len", "16", "--new-tokens", "6",
             "--precision", "fp16", "--seed", "0"]


@pytest.mark.parametrize("kernel", ["paged", "xla"])
def test_cli_fp16_matches_jax_cli(kernel, monkeypatch, capsys):
    """--precision fp16 (reduced gemma2-2b): the port's CLI, with the
    kernel path (its plain version on the CPU, fp16 queries) and with
    the gather, and the JAX CLI with the same flags and the same weights
    (the JAX init at --seed, carried to the port by the bridge) emit the
    same greedy tokens, all logits finite. The JAX side runs
    --attn-kernel xla: its Pallas kernel fails on jax 0.9.0."""
    from repro.launch import serve as jserve
    made = []

    def recording(*a, **k):
        made.extend(jserve_requests(*a, **k))
        return made

    jserve_requests = jserve.synthetic_requests
    monkeypatch.setattr(jserve, "synthetic_requests", recording)
    monkeypatch.setattr(sys, "argv", ["serve", *FP16_ARGV,
                                      "--attn-kernel", "xla"])
    jserve.main()
    jreport = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = {i: r.generated.tolist() for i, r in enumerate(made)}

    ja = jreduced("gemma2-2b")
    jp = ja.init(jax.random.PRNGKey(0))
    tp = params_from_jax(tconfigs.reduced_arch("gemma2-2b").cfg,
                         jax.tree.map(np.asarray, jp))
    monkeypatch.setattr(type(tconfigs.reduced_arch("gemma2-2b")), "init",
                        lambda self, gen: tp)
    stats, done = tserve.main(["--device", "cpu", *FP16_ARGV,
                               "--attn-kernel", kernel])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["precision"] == jreport["precision"] == "fp16"
    assert stats["nonfinite_logit_steps"] == 0
    assert {r.rid: r.generated.tolist() for r in done} == want


@pytest.mark.parametrize("argv", [
    ["--arch", "granite-moe-3b-a800m", "--attn-kernel", "paged"],
    ["--arch", "mamba2-130m", "--attn-kernel", "paged"],
    ["--arch", "mamba2-130m", "--chunk-budget", "32"],
    ["--arch", "jamba-1.5-large-398b", "--attn-kernel", "paged"],
    ["--arch", "grok-1-314b", "--engine", "static"],
    ["--arch", "granite-moe-3b-a800m", "--cache", "dense"]])
def test_cli_serves_the_new_archs(argv, capsys):
    stats, done = tserve.main(["--device", "cpu", "--requests", "3",
                               "--prompt-len", "12", "--new-tokens", "4",
                               *argv])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["requests"] == 3 == len(done)
    assert report["tokens"] == sum(len(r.generated) for r in done) > 0
    if report["engine"] == "continuous":
        assert stats["nonfinite_logit_steps"] == 0
