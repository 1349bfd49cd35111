"""The port's serving slice against the JAX package: block allocator and
pool invariants, precision casting, the whole engine (reduced gemma2-2b,
fp32, the port's kernel path vs the JAX engine's XLA path: greedy tokens
must be equal) and the port's CLI on the CPU."""
import json
import re

import numpy as np
import pytest
import torch

from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import synthetic_requests as jax_requests
from repro.serving.block_allocator import BlockTableMap as JaxMap
from repro_torch.launch import serve as tserve
from repro_torch.serving import (ContinuousEngine, Request,
                                 synthetic_requests)
from repro_torch.serving.block_allocator import BlockTableMap


def test_block_table_map_matches_jax_under_random_ops():
    """Insert / grow / evict sequences leave identical tables and
    counters in the port's map and the JAX package's, and keep the
    refcount / registry / retained-LRU invariants."""
    rng = np.random.default_rng(0)
    kw = dict(retain_limit=3, watermark=1)
    maps = [BlockTableMap(4, 32, 8, 14, **kw), JaxMap(4, 32, 8, 14, **kw)]
    prefix = rng.integers(5, 100, size=16)
    active = {}
    for _ in range(200):
        slot = int(rng.integers(4))
        if slot in active and rng.random() < 0.3:
            for m in maps:
                m.evict(slot)
            del active[slot]
        elif slot in active:
            row = active[slot] = active[slot] + 1
            res = []
            for m in maps:
                try:
                    res.append(m.grow(slot, row))
                except RuntimeError:     # NoBlocksError, in either package
                    res.append("full")
            assert res[0] == res[1]
            if res[0] == "full":
                for m in maps:
                    m.evict(slot)
                del active[slot]
        else:
            plen = int(rng.integers(4, 24))
            prompt = np.concatenate([prefix, rng.integers(5, 100, size=8)])
            ok = []
            for m in maps:
                try:
                    m.insert(slot, prompt, plen, -(-plen // 8) * 8, 6,
                             lazy=True)
                    ok.append(True)
                except RuntimeError:     # NoBlocksError, in either package
                    ok.append(False)
            assert ok[0] == ok[1]
            if ok[0]:
                active[slot] = plen
        np.testing.assert_array_equal(maps[0].table, maps[1].table)
        maps[0].check_invariants()
    assert maps[0].retained_hits == maps[1].retained_hits
    assert maps[0].prefix_misses == maps[1].prefix_misses


def test_bf16_policy_casts_like_jax(gemma_pair):
    """Same leaf dtypes as the JAX policy: bf16 weights, fp32 norms."""
    import jax
    from repro.precision import get_policy as jax_policy
    from repro_torch.precision import get_policy
    _, jparams, _, tparams = gemma_pair
    jcast = jax_policy("bf16").cast_params(jparams)
    tcast = get_policy("bf16").cast_params(tparams)
    jleaves = jax.tree_util.tree_leaves_with_path(jcast)
    for path, leaf in jleaves:
        node = tcast
        for k in path:
            node = node[k.key]
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
        np.testing.assert_array_equal(node.float().numpy(),
                                      np.asarray(leaf, np.float32))


SERVE_CASES = {
    "plain": dict(n=8, prompt_len=24, new_tokens=12, shared_prefix=0,
                  slots_budget=None, block_size=16),
    # arena of 2 dense slots under 4 slots, 8-row blocks: lazy admission
    # lets prompts in and decode growth must preempt
    "shared_prefix_preempt": dict(n=6, prompt_len=8, new_tokens=16,
                                  shared_prefix=8, slots_budget=2,
                                  block_size=8),
}


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_engine_tokens_match_jax_engine(gemma_pair, case):
    """The whole slice: the port's engine with the kernel path (its plain
    version on the CPU) emits exactly the JAX engine's greedy tokens
    (XLA gather path), fp32 policy on both sides, with prefix sharing,
    lazy growth and preemption exercised in the second case."""
    jarch, jparams, tarch, tparams = gemma_pair
    c = SERVE_CASES[case]
    max_len = c["prompt_len"] + c["new_tokens"] + c["shared_prefix"]
    bs = c["block_size"]
    max_len = -(-max_len // bs) * bs
    kw = dict(max_batch=4, max_len=max_len, policy="fp32",
              prefill_bucket=8, slots_budget=c["slots_budget"],
              block_size=bs)
    req_kw = dict(prompt_len=c["prompt_len"], new_tokens=c["new_tokens"],
                  seed=0, shared_prefix=c["shared_prefix"])
    jeng = JaxEngine(jarch, jparams, cache="paged", attn_kernel="xla", **kw)
    jdone = jeng.run(jax_requests(c["n"], jarch.cfg.vocab, **req_kw))
    teng = ContinuousEngine(tarch, tparams, attn_kernel="paged", **kw)
    tdone = teng.run(synthetic_requests(c["n"], tarch.cfg.vocab, **req_kw))
    want = {r.rid: r.generated.tolist() for r in jdone}
    got = {r.rid: r.generated.tolist() for r in tdone}
    assert got == want
    jrep, trep = jeng.report(1.0), teng.report(1.0)
    for key in ("decode_steps", "preemptions", "shared_block_hits",
                "retained_block_hits", "prefix_misses"):
        assert trep[key] == jrep[key], key
    if case != "plain":
        assert trep["preemptions"] > 0 and trep["shared_block_hits"] > 0
    teng.pool.check_invariants()
    teng.scheduler.check_invariants()
    assert all(m.alloc.n_live == 0 for m in teng.pool.maps.values())


@pytest.mark.parametrize("kernel", ["paged", "xla"])
@pytest.mark.parametrize("name", ["qwen2.5-14b", "chameleon-34b"])
def test_new_decoders_serve_like_jax(name, kernel):
    """Reduced qwen2.5-14b (QKV bias) and chameleon-34b (QK-norm) through
    the port's continuous engine on the paged pool, with the kernel path
    (its plain version on the CPU) and the gather path: the greedy
    tokens of the JAX engine (XLA gather), fp32 policy on both sides."""
    import jax
    from repro.configs import reduced_arch as jreduced
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import reduced_arch as treduced
    jarch, tarch = jreduced(name), treduced(name)
    jparams = jarch.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(tarch.cfg, jax.tree.map(np.asarray, jparams))
    kw = dict(max_batch=4, max_len=48, policy="fp32", prefill_bucket=8,
              block_size=8)
    req_kw = dict(prompt_len=16, new_tokens=12, seed=0, shared_prefix=8)
    jdone = JaxEngine(jarch, jparams, cache="paged", attn_kernel="xla",
                      **kw).run(jax_requests(5, jarch.cfg.vocab, **req_kw))
    teng = ContinuousEngine(tarch, tparams, attn_kernel=kernel, **kw)
    tdone = teng.run(synthetic_requests(5, tarch.cfg.vocab, **req_kw))
    assert ({r.rid: r.generated.tolist() for r in tdone}
            == {r.rid: r.generated.tolist() for r in jdone})
    assert teng.report(1.0)["nonfinite_logit_steps"] == 0


ENGINES = {
    "paged": dict(attn_kernel="paged"),
    "paged-xla": dict(attn_kernel="xla"),
    "dense": dict(cache="dense"),
    "paged-spec": dict(attn_kernel="paged", spec_k=3),
    "paged-chunked": dict(attn_kernel="paged", chunk_budget=4),
    "dense-sampled": dict(cache="dense",
                          sampler="temperature=0.8,top_k=20,seed=3"),
    "static": None,
}


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_dropped_engine_is_freed_without_the_collector(gemma_pair, kind):
    """With the collector off, an engine that has served a few requests
    is freed as soon as the last reference to it goes: its steps close
    over the arch, params, pool and sampler, never over the engine, so
    no reference cycle keeps its pools (card memory on the GPU) alive."""
    import gc
    import weakref
    _, _, tarch, tparams = gemma_pair
    reqs = synthetic_requests(3, tarch.cfg.vocab, prompt_len=8,
                              new_tokens=4, seed=0)
    kw = ENGINES[kind]
    gc.collect()
    gc.disable()
    try:
        if kw is None:
            from repro_torch.serving import ServeEngine
            eng = ServeEngine(tarch, tparams, max_len=32)
            eng.run_batch(reqs)
        else:
            kw = dict(kw)
            if "spec_k" in kw:
                kw["spec_draft"] = (tarch, tparams)
            eng = ContinuousEngine(tarch, tparams, max_batch=2, max_len=32,
                                   block_size=8, **kw)
            eng.run(reqs)
        assert all(len(r.generated) == r.max_new_tokens for r in reqs)
        ref = weakref.ref(eng)
        pools = [weakref.ref(p) for p in (getattr(eng, "pool", None),
                                          getattr(eng, "draft_pool", None))
                 if p is not None]
        del eng
        assert ref() is None
        assert all(p() is None for p in pools)
    finally:
        gc.enable()


def test_cli_serves_on_cpu(capsys):
    stats, done = tserve.main([
        "--device", "cpu", "--requests", "4", "--prompt-len", "16",
        "--new-tokens", "6", "--attn-kernel", "paged",
        "--shared-prefix", "16", "--precision", "bf16"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["requests"] == 4 == len(done)
    assert report["tokens"] == sum(len(r.generated) for r in done) > 0
    assert report["attn_kernel"] == "paged" and report["device"] == "cpu"
    assert stats["shared_block_hits"] > 0


def test_cli_defaults_to_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--requests", "1"])


CLI_SMALL = ["--device", "cpu", "--requests", "4", "--prompt-len", "12",
             "--new-tokens", "6", "--seed", "1"]


@pytest.mark.parametrize("argv", [
    ["--mesh", "2x1"], ["--mesh", "1x2"],
    ["--attn-kernel", "paged", "--interpret"],
    ["--replicas", "2", "--mesh", "2x1"]])
def test_cli_unported_features_raise(argv, tmp_path):
    """--mesh and --interpret do what the JAX launcher's do: --mesh in
    one process (no group of its ranks) exits naming both counts and
    never serves on one device; --interpret serves through the kernel's
    plain version with the kernel path's tokens and no launch;
    --replicas 2 --mesh 2x1 serves on two gloo ranks with one process's
    tokens, each replica on the mesh."""
    if argv[0] == "--mesh":
        with pytest.raises(SystemExit, match="--mesh .* needs 2 ranks, "
                                             "the process group has 1"):
            tserve.main([*CLI_SMALL, *argv])
        return
    if "--interpret" in argv:
        from repro_torch.kernels import paged_attention as pa
        launches = pa.paged_attention_fused.launches
        _, want = tserve.main([*CLI_SMALL, "--attn-kernel", "paged"])
        stats, got = tserve.main([*CLI_SMALL, *argv])
        assert stats["attn_kernel"] == "paged"
        assert pa.paged_attention_fused.launches == launches
    else:
        import multiprocessing
        from port import serve_worker as sw
        _, want = tserve.main([*CLI_SMALL, "--replicas", "2"])
        procs = sw.start(multiprocessing.get_context("spawn"),
                         sw.run_cli_rank, 2, tmp_path, "cli",
                         [*CLI_SMALL, *argv])
        ranks = sw.join(procs, tmp_path, "cli", 300)
        got = ranks[0]["tokens"]
        assert sw.same_tokens(ranks[1]["tokens"], got)
        for r in ranks:
            assert r["report"]["mesh"] == "2x1"
            assert [p["mesh_devices"] for p in
                    r["report"]["per_replica"]] == [2, 2]
    assert token_lists(got) == token_lists(want)


def token_lists(done):
    return [np.asarray(getattr(r, "generated", r)).tolist() for r in done]


def test_cli_model_mesh_serves_the_cut_hybrid(tmp_path):
    """--mesh 1x2 with reduced jamba (attention heads, MLP columns,
    experts, vocab rows and Mamba heads all cut over "model"), fp32: both
    gloo ranks serve one process's tokens."""
    import multiprocessing
    from port import serve_worker as sw
    argv = [*CLI_SMALL, "--arch", "jamba-1.5-large-398b", "--precision",
            "fp32"]
    _, want = tserve.main(argv)
    procs = sw.start(multiprocessing.get_context("spawn"), sw.run_cli_rank,
                     2, tmp_path, "cli", [*argv, "--mesh", "1x2"])
    ranks = sw.join(procs, tmp_path, "cli", 300)
    for r in ranks:
        assert r["report"]["mesh"] == "1x2"
        assert r["report"]["mesh_devices"] == 2
        assert token_lists(r["tokens"]) == token_lists(want)


def test_interpret_needs_the_paged_kernel(gemma_pair):
    """kernel_interpret applies only with attn_kernel="paged", as JAX's
    guard has it."""
    _, _, tarch, tparams = gemma_pair
    with pytest.raises(ValueError, match="kernel_interpret only applies"):
        ContinuousEngine(tarch, tparams, attn_kernel="xla",
                         kernel_interpret=True)


def test_interpret_never_calls_the_kernel_entry(gemma_pair, monkeypatch):
    """With kernel_interpret the paged branch calls K8's plain version
    itself, on any device: the kernel's entry point is never reached, and
    the tokens are the kernel path's. The pool checks no kernel layout
    then: a head_dim the kernel cannot copy (12) leaves tile_problems
    empty with the hatch, and lists it without."""
    import dataclasses
    from repro_torch.kernels import paged_attention as pa
    _, _, tarch, tparams = gemma_pair
    reqs = lambda: [Request(prompt=np.arange(5 + i, dtype=np.int32) + 7,
                            max_new_tokens=4) for i in range(3)]
    want = ContinuousEngine(tarch, tparams, max_batch=2, max_len=32,
                            attn_kernel="paged").run_batch(reqs())

    def refuse(*a, **k):
        raise AssertionError("the kernel entry was called")
    monkeypatch.setattr(pa, "paged_attention_fused", refuse)
    got = ContinuousEngine(tarch, tparams, max_batch=2, max_len=32,
                           attn_kernel="paged",
                           kernel_interpret=True).run_batch(reqs())
    assert token_lists(got) == token_lists(want)
    odd = dataclasses.replace(tarch, cfg=dataclasses.replace(
        tarch.cfg, head_dim=12))
    from repro_torch.serving import PagedCachePool
    assert PagedCachePool(odd, 2, 32, attn_kernel="paged").tile_problems
    interp = dataclasses.replace(odd, cfg=dataclasses.replace(
        odd.cfg, kernel_interpret=True))
    assert PagedCachePool(interp, 2, 32,
                          attn_kernel="paged").tile_problems == []


@pytest.mark.parametrize("argv,match", [
    (["--arch", "bert-large"],
     "bert-large is a bert arch: pass --task score or --task embed"),
    (["--task", "score"], "--task score needs a bert arch, got decoder"),
    (["--arch", "whisper-large-v3", "--task", "embed"],
     "--task embed needs a bert arch, got encdec"),
    (["--shared-inputs", "2"],
     "--shared-inputs does not apply to decoder archs"),
    (["--arch", "whisper-large-v3", "--shared-prefix", "4"],
     "--shared-prefix does not apply to encdec archs"),
    (["--arch", "bert-large", "--task", "score", "--shared-inputs", "2"],
     "--shared-inputs does not apply to bert archs"),
    (["--arch", "whisper-large-v3", "--engine", "static"],
     "--engine static is decoder-only, got encdec")])
def test_cli_family_flag_errors(argv, match):
    """Flags that do not fit the arch's family raise the JAX launcher's
    errors, in its wording."""
    with pytest.raises(SystemExit, match=re.escape(match)):
        tserve.main(["--device", "cpu", *argv])


CLI_ARGV = ["--device", "cpu", "--requests", "4", "--prompt-len", "12",
            "--new-tokens", "6", "--seed", "1"]


def _cli(capsys, *argv):
    stats, done = tserve.main([*CLI_ARGV, *argv])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["requests"] == 4 == len(done)
    assert report["tokens"] == sum(len(r.generated) for r in done) > 0
    return report, {r.rid: r.generated.tolist() for r in done}


def test_cli_serves_static_engine(capsys):
    """--engine static runs the padded lockstep baseline in waves of
    --max-batch: greedy fp32 tokens equal the continuous paged run's."""
    report, static = _cli(capsys, "--engine", "static")
    assert (report["engine"], report["cache"]) == ("static", "static")
    assert report["attn_kernel"] == "xla"
    _, paged = _cli(capsys, "--attn-kernel", "paged")
    assert static == paged


@pytest.mark.parametrize("policy", ["prefix", "depth", "rr"])
def test_cli_replicas_route_like_one_engine(capsys, policy):
    """--replicas 2 --route-policy P serves through a ReplicaRouter over
    two engines sharing one params tree: the same greedy tokens as
    --replicas 1, and the fleet's report (JAX's fields)."""
    argv = [*CLI_ARGV, "--shared-prefix", "16", "--attn-kernel", "paged"]
    by_prompt = lambda done: {r.prompt.tobytes(): r.generated.tolist()
                              for r in done}
    _, done1 = tserve.main(argv)
    capsys.readouterr()
    _, done2 = tserve.main([*argv, "--replicas", "2", "--route-policy",
                                policy])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert by_prompt(done2) == by_prompt(done1) and len(done2) == 4
    assert report["replicas"] == 2 and report["route_policy"] == policy
    assert report["completed"] == 4 and report["routed_submits"] == 4
    assert report["attn_kernel"] == "paged" and report["mesh"] == "1x1"
    assert len(report["per_replica"]) == 2
    if policy == "prefix":   # one shared system prompt: one home replica
        assert report["routed_affinity_hits"] == 3
        assert [r["requests"] for r in report["per_replica"]] in (
            [4, 0], [0, 4])


def test_cli_serves_dense_cache(capsys):
    report, dense = _cli(capsys, "--cache", "dense")
    assert (report["engine"], report["cache"]) == ("continuous", "dense")
    assert report["attn_kernel"] == "xla" and "growth" not in report
    _, paged = _cli(capsys)
    assert dense == paged


def test_cli_serves_self_draft_speculation(capsys):
    """--spec-draft self --spec-k 3: the draft is the target, so every
    proposal is accepted and the tokens equal the non-spec run's."""
    report, spec = _cli(capsys, "--spec-draft", "self", "--spec-k", "3",
                        "--attn-kernel", "paged")
    assert report["spec_k"] == 3 and report["spec_rounds"] > 0
    assert report["acceptance_rate"] == 1.0
    assert report["decode_steps"] == report["spec_rounds"]
    _, plain = _cli(capsys, "--attn-kernel", "paged")
    assert spec == plain


def test_cli_serves_sampled_decoding(capsys):
    """A sampled stream is a function of (seed, rid, token index): equal
    between the paged and the dense pool and between spec and non-spec,
    and not the greedy stream."""
    sampler = ["--sampler", "temperature=0.8,top_k=50,top_p=0.9,seed=3"]
    report, paged = _cli(capsys, *sampler)
    assert report["sampler"] == sampler[1]
    _, dense = _cli(capsys, *sampler, "--cache", "dense")
    _, spec = _cli(capsys, *sampler, "--spec-draft", "self")
    _, greedy = _cli(capsys)
    assert paged == dense == spec != greedy


def test_cli_serves_chunked_open_loop(capsys):
    """--chunk-budget 8 --arrival-rate 50: the stream is replayed on a
    seeded Poisson clock through chunked admission; the report has the
    chunk counters and the goodput keys, and the tokens equal the
    closed-loop whole-prompt run's, also under arrival-deadline."""
    report, chunked = _cli(capsys, "--chunk-budget", "8",
                           "--arrival-rate", "50", "--attn-kernel", "paged")
    assert report["chunk_budget"] == 8 and report["chunk_steps"] > 0
    assert report["chunk_tokens"] >= 4 * 8
    for key in ("goodput_tokens_per_s", "slo_attainment", "ttft_violations",
                "itl_violations", "slo_ttft_ms", "slo_itl_ms"):
        assert key in report, key
    assert (report["slo_ttft_ms"], report["slo_itl_ms"]) == (1000.0, 200.0)
    assert report["completed"] == 4
    assert 0.0 <= report["slo_attainment"] <= 1.0
    _, whole = _cli(capsys, "--attn-kernel", "paged")
    report, deadline = _cli(capsys, "--sched-policy", "arrival-deadline",
                            "--chunk-budget", "8")
    assert report["sched_policy"] == "arrival-deadline"
    assert chunked == whole == deadline


def test_cli_chunk_budget_with_a_draft_raises_as_jax_does(gemma_pair):
    """--chunk-budget with --spec-draft passes the flag checks (both are
    paged-pool flags) and the engine refuses the pair with the JAX
    engine's message."""
    from repro.serving import ContinuousEngine as JaxContinuous
    jarch, jparams, _, _ = gemma_pair
    with pytest.raises(ValueError) as want:
        JaxContinuous(jarch, jparams, max_batch=2, max_len=32,
                      spec_draft=(jarch, jparams), chunk_budget=8)
    with pytest.raises(ValueError) as got:
        tserve.main([*CLI_ARGV, "--chunk-budget", "8", "--spec-draft",
                     "self"])
    assert str(got.value) == str(want.value)
    assert "mutually exclusive" in str(got.value)


DIFFERENTIAL = {"bf16": ("bf16", 0), "fp32-shared-prefix": ("fp32", 16)}


@pytest.mark.parametrize("case", sorted(DIFFERENTIAL))
@pytest.mark.parametrize("name", ["gemma2-2b", "qwen2.5-14b"])
def test_engine_differential(name, case):
    """docs/architecture.md's differential in the port: static, dense,
    paged with the gather, paged with the kernel (its plain version on
    the CPU) and chunked paged emit the same greedy tokens, in bf16 and
    in fp32 with a 16-token shared prefix (tests/test_serving_engine.py's
    workload); the whole-prompt paged pools share the prefix's blocks,
    the chunked one never content-addresses its blocks."""
    import jax
    from repro.configs import reduced_arch as jreduced
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import reduced_arch as treduced
    from repro_torch.serving import ServeEngine
    policy, prefix = DIFFERENTIAL[case]
    arch = treduced(name)
    params = params_from_jax(arch.cfg, jax.tree.map(
        np.asarray, jreduced(name).init(jax.random.PRNGKey(0))))
    paged = dict(max_batch=3, max_len=48, policy=policy, cache="paged",
                 block_size=8, prefill_bucket=8)
    engines = {
        "static": lambda: ServeEngine(arch, params, max_len=48,
                                      policy=policy),
        "dense": lambda: ContinuousEngine(arch, params, max_batch=2,
                                          max_len=48, policy=policy,
                                          cache="dense", prefill_bucket=8),
        "paged-gather": lambda: ContinuousEngine(arch, params,
                                                 attn_kernel="xla", **paged),
        "paged-kernel": lambda: ContinuousEngine(arch, params,
                                                 attn_kernel="paged",
                                                 **paged),
        "chunked": lambda: ContinuousEngine(arch, params, attn_kernel="paged",
                                            chunk_budget=6, **paged)}
    spec = [(7, 4), (11, 6), (5, 1), (9, 3), (11, 4)]
    outs = {}
    for kind, build in engines.items():
        # tests/conftest.make_serving_requests
        common = np.random.default_rng([1, 999]).integers(
            5, arch.cfg.vocab, size=prefix).astype(np.int32)
        reqs = [Request(prompt=np.concatenate([
                            common, np.random.default_rng([1, i]).integers(
                                5, arch.cfg.vocab, size=n).astype(np.int32)]),
                        max_new_tokens=m) for i, (n, m) in enumerate(spec)]
        eng = build()
        eng.run_batch(reqs)
        outs[kind] = [r.generated.tolist() for r in reqs]
        if kind.startswith("paged"):
            assert (eng.pool.shared_hits > 0) == (prefix > 0)
        if kind == "chunked":
            rep = eng.report(1.0)
            assert rep["shared_block_hits"] == rep["prefix_misses"] == 0
            eng.pool.check_invariants()
    assert all(o == outs["static"] for o in outs.values()), {
        k: o == outs["static"] for k, o in outs.items()}


@pytest.mark.parametrize("argv", [
    [], ["--spec-draft", "truncated", "--spec-k", "2"],
    ["--engine", "static", "--attn-kernel", "paged"],
    ["--cache", "dense", "--spec-draft", "self", "--spec-k", "3"],
    ["--engine", "static", "--cache", "dense", "--growth", "eager",
     "--watermark", "2", "--slots-budget", "2", "--retain-blocks", "4"],
    ["--engine", "static", "--sched-policy", "arrival-deadline",
     "--slo-ms", "5", "--no-preempt", "--spec-k", "3"],
    ["--cache", "dense", "--chunk-budget", "8", "--replicas", "2",
     "--route-policy", "rr", "--interpret"],
    ["--interpret"], ["--attn-kernel", "xla", "--interpret"],
    ["--engine", "static", "--mesh", "2x1", "--arrival-rate", "3"],
    ["--cache", "dense", "--chunk-budget", "8"],
    ["--engine", "static", "--arrival-rate", "2"],
    ["--engine", "static", "--cache", "dense", "--chunk-budget", "4",
     "--arrival-rate", "2", "--sched-policy", "arrival-deadline"],
    ["--chunk-budget", "8", "--arrival-rate", "2", "--sched-policy",
     "arrival-deadline"]])
def test_cli_flag_errors_match_jax_launcher(argv):
    """The ported flag-compatibility matrix gives the JAX launcher's
    errors word for word, and main raises them before anything runs."""
    from repro.launch import serve as jserve
    errs = tserve.flag_errors(tserve.build_parser().parse_args(argv))
    assert errs == jserve.flag_errors(jserve.build_parser().parse_args(argv))
    if errs:
        with pytest.raises(SystemExit) as e:
            tserve.main(["--device", "cpu", *argv])
        assert str(e.value) == "; ".join(errs)


@pytest.mark.parametrize("spec", ["greedy", "temperature=0",
                                  "temperature=0,stable=1"])
def test_sampler_greedy_picks_match_jax(spec):
    """Greedy and the bf16 tie band pick the same tokens as the JAX
    sampler, on logits with near-ties planted one bf16 ulp apart."""
    import jax.numpy as jnp
    from repro.serving.sampler import Sampler as JaxSampler
    from repro_torch.serving import Sampler
    logits = np.random.default_rng(0).normal(size=(6, 50)).astype(np.float32)
    logits[:3, 7] = logits[:3].max(axis=1) + 2.0 ** -9
    logits[:3, 3] = logits[:3, 7] - 2.0 ** -9
    js, ts = JaxSampler.parse(spec), Sampler.parse(spec)
    assert (ts.greedy, ts.stable_tiebreak) == (js.greedy, js.stable_tiebreak)
    want = np.asarray(js.sample(jnp.asarray(logits), None))
    got = ts.sample(torch.from_numpy(logits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _serve_decode_example():
    import importlib.util
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[2]
    spec = importlib.util.spec_from_file_location(
        "serve_decode_torch", root / "examples" / "serve_decode_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_decode_example_matches_jax_example(gemma_pair):
    """examples/serve_decode_torch.py started from examples/serve_decode.py's
    params (reduced gemma2-2b, PRNGKey(0), carried over by the bridge)
    serves that example's batch to its tokens through throughput_probe
    (the JAX recipe is repeated here); on its own seed it runs too, and
    its --device default is the card."""
    import contextlib
    import io
    from repro.serving.engine import Request as JaxRequest
    from repro.serving.engine import ServeEngine as JaxServe
    from repro.serving.engine import throughput_probe as jax_probe
    jarch, jparams, _, tparams = gemma_pair
    rng = np.random.default_rng(0)
    jreqs = [JaxRequest(prompt=rng.integers(5, jarch.cfg.vocab,
                                            size=24).astype(np.int32),
                        max_new_tokens=16) for _ in range(4)]
    jax_probe(JaxServe(jarch, jparams, max_len=40), jreqs)
    example = _serve_decode_example()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        stats, reqs = example.main(["--device", "cpu"], params=tparams)
        example.main(["--device", "cpu", "--batch", "2"])
    assert out.getvalue().strip().endswith("serve_decode OK")
    assert ([r.generated.tolist() for r in reqs]
            == [r.generated.tolist() for r in jreqs])
    assert stats["warmup"] is True and stats["tokens"] == 4 * 16
    assert stats["tokens_per_s"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            example.main([])


@pytest.mark.parametrize("cache,sampler", [
    ("paged", None), ("dense", None),
    ("paged", "temperature=0.8,top_k=50,top_p=0.9,seed=3")])
def test_run_one_matches_pooled_decoder(gemma_pair, cache, sampler):
    """run_one serves a decoder request at batch 1 outside the pool:
    greedy and sampled tokens equal the pooled engine's (the same
    left-pad masking and per-token keys) and the JAX engine's run_one;
    a request longer than max_len is refused."""
    jarch, jparams, tarch, tparams = gemma_pair
    kw = dict(max_batch=3, max_len=48, policy="fp32", prefill_bucket=8,
              block_size=8, cache=cache, sampler=sampler)
    eng = ContinuousEngine(tarch, tparams, **kw)
    jeng = JaxEngine(jarch, jparams, **kw)
    pooled = eng.run_batch(synthetic_requests(5, tarch.cfg.vocab,
                                              prompt_len=14, new_tokens=9,
                                              seed=4))
    solo = synthetic_requests(5, tarch.cfg.vocab, prompt_len=14,
                              new_tokens=9, seed=4)
    jsolo = jax_requests(5, jarch.cfg.vocab, prompt_len=14, new_tokens=9,
                         seed=4)
    for p, s, j in zip(pooled, solo, jsolo):
        s.rid, j.rid = p.rid, p.rid          # the sampler keys on the rid
        assert eng.run_one(s).generated.tolist() == p.generated.tolist()
        assert np.asarray(jeng.run_one(j).generated).tolist() == \
            s.generated.tolist()
        assert len(s.trace.token_ts) == s.max_new_tokens
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.run_one(Request(prompt=np.arange(5, 45, dtype=np.int32),
                            max_new_tokens=9))
