"""The port's serving engine on a mesh (serving/engine.py: mesh=), ranks
under gloo on the CPU, against the port's one-device engine and the JAX
package's engine on a mesh of two host devices. The port of
tests/test_sharded_serving.py, case by case, on its configs: reduced
qwen2.5-14b, block 8, max_batch 2, max_len 48, the 4-request stream with
a shared 16-token prefix.

Each layout (2 x 1, 1 x 2 and 2 x 2) runs once, in one set of processes
started with the spawn method (tests/port/serve_worker.py) over a
FileStore under tmp_path, for all of its cases; the one-device
references run here meanwhile, with one CPU thread as each rank.

  * 2 x 1 (slots and arena blocks over "data"): the paged and dense
    pools under the arch's own policy (bf16 compute), fp32, the kernel
    path, chunked prefill and speculative decoding each give one
    device's tokens; so does a prefix-affinity router over two replicas
    on the mesh;
  * 1 x 2 (attention on whole KV heads, MLP columns and the vocab over
    "model", each pick taken over the ranks' logit columns): fp32 tokens
    equal one device's, with the gather and with K8 on the local heads;
    chunked and speculative under the arch's policy too; under bf16 the
    same-layout pair (paged vs chunked-paged with the tie-stable argmax)
    agrees;
  * 2 x 2: fp32 tokens equal one device's, gather and kernel;
  * 2 x 1 at max_batch 3 (slots that do not divide over "data": every
    data rank holds and decodes all three): one device's tokens;
  * run_one on 2 x 1 and 1 x 2 engines, for reduced qwen2.5-14b,
    whisper-large-v3 and BERT scoring (each request alone at batch 1,
    whole on every data rank, each model rank on its cut): the pooled
    stream's output on one device (BERT's pooled vectors within the
    envelope test's tolerance);
  * the MoE, Mamba-2 and hybrid decoders (reduced granite-moe-3b-a800m,
    mamba2-130m and jamba-1.5-large-398b, fp32, jamba through K8's path)
    on 2 x 1 and 1 x 2: one device's tokens; on 1 x 2 in the cut layout
    (distributed/sharding.py: serve_params): each rank its experts, its
    vocab rows and its Mamba heads, in_proj and conv_w placed at load in
    its heads' columns, its heads' SSM state and its channels' conv
    tail; no expert stack, divisible vocab table or Mamba projection
    whole on a rank;
  * whisper-large-v3 and BERT scoring on 1 x 2 with the vocab cut:
    whisper's tokens and BERT's MLM ids equal one device's, the pooled
    vectors within the envelope test's tolerance (rtol 1e-4, atol 1e-6:
    the split matmuls sum in another order);
  * JAX's ContinuousEngine on 2 x 1 and 1 x 2 meshes of two host devices
    (a subprocess) gives the port's mesh tokens, fp32, and on 1 x 2 also
    for the three MoE / Mamba families, whose leaves JAX's XLA program
    cuts over "model" too;
  * every rank's host state (scheduler queue, slots and completions,
    every share's block tables and hit counters, picked tokens) equals
    every other's at the end of each run;
  * each rank's pool holds its share: on 2 x 1 the n_blocks / 2 data
    blocks of its arena share (and a null block of its own), on 1 x 2
    n_kv / 2 KV heads, so that a rank's data-block bytes are 1/2 of one
    device's (all of its arena bytes on 1 x 2); the shapes follow
    distributed/sharding.py:serve_pspec;
  * planted faults fail the comparison: the last data rank dropping its
    last slot's token from the gather, K8's plain version handed a local
    arena with the global KV-head count, and a vocab-parallel pick that
    ignores the rank's column offset;
  * decisions that read a clock come out alike on every rank although
    rank 1's own clock runs a thousand times fast: SLO eviction under
    the deadline policy, and an open-loop driver's arrivals;
  * a NaN in rank 1's logits reaches rank 0's report.
"""
import json
import multiprocessing
import os
import subprocess
import sys
import textwrap
import types

import jax
import numpy as np
import pytest
import torch

from port import serve_worker as sw
from repro.configs import reduced_arch as jreduced
from repro_torch.bridge import params_from_jax
from repro_torch.configs import reduced_arch
from repro_torch.distributed import sharding as shd

FAMILIES = ["granite", "mamba2", "jamba"]
VOCAB_CUT = ["whisper", "bert"]         # 1 x 2: the vocab cut
# run_one on a mesh engine: a decoder, whisper and BERT scoring, each
# request at batch 1, against the pooled stream's one-device output
RUN_ONE = {"one-fp32": "fp32", "one-whisper": "whisper", "one-bert": "bert"}
LAYOUT_CASES = {
    "2x1": ["paged", "dense", "chunked", "spec", "placement", "fp32",
            "kernel-fp32", "router", "fault-drop", "parse_mesh",
            "clock-slo", "clock-open-loop", "nan-rank1", *FAMILIES,
            "fp32-b3", *RUN_ONE],
    "1x2": ["fp32", "kernel-fp32", "bf16-stable", "bf16-stable-chunked",
            "chunked", "spec", "placement", "fault-global-kv",
            "fault-vocab-offset", *FAMILIES, *VOCAB_CUT, *RUN_ONE],
    "2x2": ["fp32", "kernel-fp32"],
}
# one-device references
REFS = ["paged", "dense", "spec", "placement", "fp32", "kernel-fp32",
        "fp32-b3", *FAMILIES, *VOCAB_CUT]
# (layout, case) -> the one-device case it must equal
EXPECT = {
    ("2x1", "paged"): "paged", ("2x1", "dense"): "paged",
    ("2x1", "chunked"): "paged", ("2x1", "spec"): "spec",
    ("2x1", "placement"): "placement", ("2x1", "fp32"): "fp32",
    ("2x1", "kernel-fp32"): "kernel-fp32", ("2x1", "router"): "paged",
    ("2x1", "clock-slo"): "paged",
    ("1x2", "fp32"): "fp32", ("1x2", "kernel-fp32"): "kernel-fp32",
    ("1x2", "chunked"): "paged", ("1x2", "spec"): "spec",
    ("1x2", "placement"): "placement",
    ("2x2", "fp32"): "fp32", ("2x2", "kernel-fp32"): "kernel-fp32",
    **{(lay, f): f for lay in ("2x1", "1x2") for f in FAMILIES},
    **{("1x2", f): f for f in VOCAB_CUT},
    ("2x1", "fp32-b3"): "fp32-b3",
    **{(lay, c): ref for lay in ("2x1", "1x2") for c, ref in RUN_ONE.items()},
}
FAULTS = {("2x1", "fault-drop"): "fp32",
          ("1x2", "fault-global-kv"): "kernel-fp32",
          ("1x2", "fault-vocab-offset"): "fp32"}
JAX_FAMILIES = {f: sw.CASES[f]["arch"] for f in FAMILIES}
JOIN_S = 300

_JAX_MESH = textwrap.dedent("""
    import json, sys
    import jax
    import numpy as np
    from repro.configs import reduced_arch
    from repro.launch.mesh import make_local_mesh
    from repro.serving import ContinuousEngine, Request
    work = np.load(sys.argv[1])
    runs = [(name, "qwen2.5-14b", lay) for name, lay in
            (("2x1", (2, 1)), ("1x2", (1, 2)))]
    runs += [(case, arch, (1, 2)) for case, arch in
             json.loads(sys.argv[2]).items()]
    out = {}
    for name, arch_name, (data, model) in runs:
        arch = reduced_arch(arch_name)
        params = arch.init(jax.random.PRNGKey(0))
        reqs = [Request(prompt=work[f"{arch_name}/p{i}"],
                        max_new_tokens=int(n))
                for i, n in enumerate(work[f"{arch_name}/new"])]
        eng = ContinuousEngine(arch, params, cache="paged", block_size=8,
                               max_batch=2, max_len=48, policy="fp32",
                               mesh=make_local_mesh(data=data, model=model))
        eng.run(reqs)
        out[name] = [np.asarray(r.generated).tolist() for r in reqs]
    print(json.dumps(out))
""")


def _jax_start(tmp, works):
    """JAX's engine on both two-device meshes (qwen2.5-14b) and on 1 x 2
    (the MoE / Mamba families), in a subprocess (started). works: {arch
    name: its stream4 requests}."""
    path = tmp / "work.npz"
    arrays = {}
    for name, work in works.items():
        arrays[f"{name}/new"] = np.array([n for _, n, _ in work])
        arrays.update({f"{name}/p{i}": p
                       for i, (p, _, _) in enumerate(work)})
    np.savez(path, **arrays)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
           "PYTHONPATH": os.pathsep.join(
               [os.path.abspath("src"), os.environ.get("PYTHONPATH", "")])}
    return subprocess.Popen([sys.executable, "-c", _JAX_MESH, str(path),
                             json.dumps(JAX_FAMILIES)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{layout: [rank results]}, "one": {case: one-device result},
    "jax": {layout: tokens}."""
    tmp = tmp_path_factory.mktemp("serve")
    # JAX's init, carried by the bridge: the JAX engines serve the same
    # weights
    params = {}
    for name in {"qwen2.5-14b"} | {sw.CASES[f]["arch"]
                                   for f in FAMILIES + VOCAB_CUT}:
        jparams = jreduced(name).init(jax.random.PRNGKey(0))
        params[name] = params_from_jax(reduced_arch(name).cfg,
                                       jax.tree.map(np.asarray, jparams))
    inputs = tmp / "params.pt"
    torch.save(params, inputs)
    jax_proc = _jax_start(tmp, {
        name: sw.workload("stream4", reduced_arch(name))
        for name in {"qwen2.5-14b", *JAX_FAMILIES.values()}})
    ctx = multiprocessing.get_context("spawn")
    procs = {lay: sw.start(ctx, sw.run_rank,
                           sw.LAYOUTS[lay]["data"] * sw.LAYOUTS[lay]["model"],
                           tmp, lay, sw.LAYOUTS[lay], names, str(inputs))
             for lay, names in LAYOUT_CASES.items()}
    out = {"one": {}}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for name in REFS:
            out["one"][name] = sw.run_case(name, params)
    finally:
        torch.set_num_threads(threads)
        for lay, ranks in procs.items():
            out[lay] = sw.join(ranks, tmp, lay, JOIN_S)
        stdout, stderr = jax_proc.communicate(timeout=600)
    assert jax_proc.returncode == 0, stderr[-2000:]
    out["jax"] = json.loads(stdout.strip().splitlines()[-1])
    return out


def test_workload_is_the_jax_tests_stream():
    """The stream the ranks serve is tests/conftest.py's
    make_serving_requests, byte for byte."""
    from conftest import make_serving_requests
    jarch = jreduced("qwen2.5-14b")
    want = make_serving_requests(jarch, [(8, 5), (12, 6), (8, 4), (16, 5)],
                                 seed=2, prefix=16)
    got = sw.workload("stream4", reduced_arch("qwen2.5-14b"))
    for r, (p, n, _) in zip(want, got):
        assert np.array_equal(r.prompt, p) and r.max_new_tokens == n


@pytest.mark.parametrize("layout,case", sorted(EXPECT))
def test_mesh_tokens_equal_one_device(runs, layout, case):
    got = runs[layout][0][case]
    want = runs["one"][EXPECT[layout, case]]
    assert sw.same_tokens(got["tokens"], want["tokens"])
    lay = sw.LAYOUTS[layout]
    if case != "router":
        assert got["report"]["mesh_devices"] == lay["data"] * lay["model"]
    if case == "chunked":
        assert got["report"]["chunk_steps"] > 0
    if case == "spec":
        assert got["report"]["acceptance_rate"] == pytest.approx(1.0)
    if case == "router":
        rep = got["report"]
        assert rep["replicas"] == 2
        assert all(sub["mesh_devices"] == 2 for sub in rep["per_replica"])
    base = [e for e in want["embeddings"] if e is not None]
    emb = [e for e in got["embeddings"] if e is not None]
    assert len(emb) == len(base) == (5 if case == "bert" else len(emb))
    for x, y in zip(base, emb):
        np.testing.assert_allclose(y, x, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("layout", sorted(LAYOUT_CASES))
def test_ranks_agree(runs, layout):
    """Every rank's scheduler, block tables, hit counters and tokens are
    every other rank's, for every case."""
    ranks = runs[layout]
    for name in LAYOUT_CASES[layout]:
        if name != "parse_mesh":
            assert sw.ranks_agree(ranks, name), name


def test_model_mesh_bf16_stable_same_layout_pair(runs):
    """bf16 on 1 x 2, paged vs chunked-paged: one layout, one rounding,
    and the tie-stable argmax keeps chunk boundaries invisible."""
    r = runs["1x2"][0]
    assert sw.same_tokens(r["bf16-stable"]["tokens"],
                          r["bf16-stable-chunked"]["tokens"])


@pytest.mark.parametrize("layout,case", [("2x1", "fp32"), ("1x2", "fp32")]
                         + [("1x2", f) for f in FAMILIES])
def test_jax_mesh_engine_gives_the_same_tokens(runs, layout, case):
    """JAX's engine on the same two-device layout, fp32: the same tokens
    as the port's mesh (and so as one device); for the MoE / Mamba
    families on 1 x 2, where both cut experts, vocab and Mamba heads."""
    got = [t.tolist() for t in runs[layout][0][case]["tokens"]]
    assert got == runs["jax"][layout if case == "fp32" else case]


@pytest.mark.parametrize("layout,case", sorted(FAULTS))
def test_planted_faults_fail_the_comparison(runs, layout, case):
    got = runs[layout][0][case]["tokens"]
    assert not sw.same_tokens(got, runs["one"][FAULTS[layout, case]]["tokens"])


def _arena_items(shapes):
    return {k: v for k, v in shapes.items()
            if k.startswith("/slots/") and k.rsplit("/", 1)[1] in ("k", "v")}


def _cut_leaf(path):
    """The kind of a param leaf that a model axis of two cuts in the cut
    layout (whatever the layout does not cut: None): expert stacks,
    vocab tables, Mamba projections."""
    parts = path.split("/")
    if parts[-1] in ("up", "gate", "down"):
        return "expert"                 # (P, E, din, dout): no /kernel
    if path.endswith(("embed/embedding", "lm_head/kernel")):
        return "vocab"
    if parts[-2:] == ["out_proj", "kernel"]:
        return "out_proj"
    if parts[-2:] == ["in_proj", "kernel"] or parts[-1] == "conv_w":
        return "columns"
    return None


def _mamba_columns(arch, leaf):
    from repro_torch.distributed.sharding import (mamba_segments,
                                                  segment_columns)
    return len(segment_columns(mamba_segments(leaf, arch.mamba, 2), 2, 0))


@pytest.mark.parametrize("layout", ["2x1", "1x2"])
def test_pool_holds_its_share(runs, layout):
    """A rank's arenas: on 2 x 1 half the data blocks (and a null block
    of its own), on 1 x 2 half the KV heads, so that its data-block bytes
    (1 x 2: all its arena bytes) are half of one device's; every rank's
    shapes are rank 0's. The local shapes are the whole (the ranks'
    shares side by side) cut as serve_pspec cuts it. The MoE / Mamba
    families: on 1 x 2 a rank's SSM state holds half the heads and its
    conv tail its channels (its heads' x, B and C whole); on 2 x 1 both
    are whole (a block of slots)."""
    one = runs["one"]["placement"]["shapes"]
    lay = sw.LAYOUTS[layout]
    D, M = lay["data"], lay["model"]
    heads = reduced_arch("qwen2.5-14b").heads
    standin = types.SimpleNamespace(shape=dict(lay))
    for rank in runs[layout]:
        got = rank["placement"]["shapes"]
        assert got == runs[layout][0]["placement"]["shapes"]
        for si, n in one["n_local"].items():
            assert got["n_local"][si] == n // D
        arenas = _arena_items(got)
        assert arenas
        for path, (shape, nbytes) in arenas.items():
            oshape, obytes = one[path]
            blk = nbytes // shape[1]        # one block's bytes
            assert shape[1] - 1 == (oshape[1] - 1) // D
            assert shape[3] == oshape[3] // M and shape[4] == oshape[4]
            assert (shape[1] - 1) * blk * D * M == (oshape[1] - 1) * (
                obytes // oshape[1])
            if D == 1:
                assert nbytes * M == obytes
            # the whole: D shares of blocks, M ranks' heads
            whole = (shape[0], shape[1] * D, shape[2], shape[3] * M,
                     shape[4])
            like = types.SimpleNamespace(shape=whole, ndim=5,
                                         dtype=torch.bfloat16)
            spec = shd.serve_pspec({"k": like}, standin, heads)["k"]
            # a Groups entry (head groups) cuts its dim into its n parts
            cut = tuple(w // (s.n if isinstance(s, shd.Groups) else
                              {"data": D, "model": M}.get(s, 1))
                        for w, s in zip(whole, spec))
            assert cut == shape, (spec, whole, shape)
    for fam in ("mamba2", "jamba"):
        arch = sw.case_arch(fam)
        ones = runs["one"][fam]["shapes"]
        states = {k: v for k, v in ones.items()
                  if k.rsplit("/", 1)[-1] in ("ssm", "conv")}
        assert states
        for rank in runs[layout]:
            got = rank[fam]["shapes"]
            for path, (oshape, _) in states.items():
                shape = got[path][0]
                if path.endswith("ssm"):      # (P, rows, H, N, P)
                    assert shape[2] * M == oshape[2]
                    assert shape[3:] == oshape[3:]
                else:                         # (P, rows, W - 1, C)
                    assert shape[3] == (oshape[3] if M == 1 else
                                        _mamba_columns(arch, "conv_w"))
                # a block of slots over "data": its rows, padded to 2
                assert shape[1] == max(oshape[1] // D, 2)


@pytest.mark.parametrize("case", FAMILIES + VOCAB_CUT)
def test_model_rank_holds_no_cut_leaf_whole(runs, case):
    """On 1 x 2 each rank's params hold half of every expert stack (E
    over "model", or the ff dim), of every divisible vocab table and
    Mamba out_proj, and its columns of each in_proj and conv_w (its
    heads' z, x, dt; B and C whole): none of them whole on a rank. On 2
    x 1 every leaf stays whole."""
    arch = sw.case_arch(case)
    one = runs["one"][case]["params"]
    cut = {p: _cut_leaf(p) for p in one if _cut_leaf(p)}
    kinds = {k for k in cut.values()}
    assert "vocab" in kinds
    assert case not in ("granite", "jamba") or "expert" in kinds
    assert case not in ("mamba2", "jamba") or {"columns",
                                               "out_proj"} <= kinds
    numel = lambda s: int(np.prod(s))
    for rank in runs["1x2"]:
        got = rank[case]["params"]
        for path, kind in cut.items():
            if kind == "columns":
                leaf = "conv_w" if path.endswith("conv_w") else "in_proj"
                assert got[path][-1] == _mamba_columns(arch, leaf)
                assert got[path][:-1] == one[path][:-1]
            else:
                assert 2 * numel(got[path]) == numel(one[path]), path
    if case in FAMILIES:
        for rank in runs["2x1"]:
            assert rank[case]["params"] == one


def test_parse_mesh_on_two_ranks(runs):
    """parse_mesh on a two-rank group: '2x1', '1x2' and a bare '2'
    (1 x 2)."""
    assert runs["2x1"][0]["parse_mesh"] == {"2x1": (2, 1), "1x2": (1, 2),
                                            "2": (1, 2)}


def test_parse_mesh_needs_its_ranks():
    """Without a process group of D x M ranks --mesh exits naming both
    counts; no mesh is one device."""
    from repro_torch.launch.serve import parse_mesh
    assert parse_mesh(None) is None
    for spec, n in (("2x1", 2), ("1x2", 2), ("2", 2), ("2x2", 4)):
        with pytest.raises(SystemExit, match=f"needs {n} ranks, the "
                                             f"process group has 1"):
            parse_mesh(spec)


@pytest.mark.parametrize("model", [1, 2])
def test_serve_pspec_is_cache_pspec_on_the_data_axis(model):
    """serve_pspec equals JAX's cache_pspec wherever the model axis is 1;
    with a model axis that cuts whole heads it cuts the K/V leaves' head
    dim, never head_dim, the Mamba SSM state's heads dim and the conv
    tail's channels (its own departure from cache_pspec, which cuts
    their last dims), and leaves integer bookkeeping whole over
    "model"."""
    for name in ("qwen2.5-14b", "jamba-1.5-large-398b", "mamba2-130m"):
        arch = reduced_arch(name)
        mesh = types.SimpleNamespace(shape={"data": 2, "model": model})
        for cache in (arch.init_cache(2, 32, device="meta"),
                      arch.init_paged_cache(2, 32, block_size=8,
                                            device="meta")):
            got = shd.serve_pspec(cache, mesh, arch.heads, arch.mamba)
            want = shd.cache_pspec(cache, mesh)
            flat_g, flat_w = [], []

            def walk(g, w, c, name=None):
                if c is None:
                    return
                if isinstance(c, dict):
                    for k in c:
                        walk(g[k], w[k], c[k], k)
                elif isinstance(c, (tuple, list)):
                    for a, b, x in zip(g, w, c):
                        walk(a, b, x, name)
                else:
                    flat_g.append((name, c, g))
                    flat_w.append(w)
            walk(got, want, cache)
            for (leaf, t, g), w in zip(flat_g, flat_w):
                if model == 1 or t.ndim < 2:
                    assert g == w, (leaf, g, w)
                    continue
                if leaf == "ssm":           # (P, B, H, N, P)
                    assert tuple(g) == (w[0], w[1], "model", None, None)
                    continue
                if leaf == "conv":          # (P, B, W - 1, C)
                    assert tuple(g) == (*w[:-1], "model")
                    continue
                assert g[-1] is None and tuple(g[:-2]) == tuple(w[:-2])
                assert (g[-2] == "model") == (leaf in ("k", "v")), (leaf, g)


@pytest.mark.parametrize("case", ["clock-slo", "clock-open-loop"])
def test_clock_driven_decisions_agree(runs, case):
    """With rank 1's clock a thousand times fast, every rank's host state
    is rank 0's and every request completes in full: on rank 0's clock
    no request reaches the SLO, and the driver submits each request
    once."""
    ranks = runs["2x1"]
    assert sw.ranks_agree(ranks, case)
    want = [n for _, n, _ in sw.workload("stream4",
                                         reduced_arch("qwen2.5-14b"))]
    for rank in ranks:
        got = rank[case]
        assert got["report"]["requests"] == 4
        assert got["report"]["slo_evictions"] == 0
        assert [len(t) for t in got["tokens"]] == want


def test_nonfinite_logits_of_another_rank_are_counted(runs):
    """Rank 1's NaN logits reach every rank's report: each counts every
    decode step, the step's flags gathered with its picks, and rank 0's
    own logits are finite."""
    reps = [rank["nan-rank1"]["report"] for rank in runs["2x1"]]
    steps = reps[0]["decode_steps"]
    assert steps > 0
    assert [r["nonfinite_logit_steps"] for r in reps] == [steps, steps]
    assert sw.ranks_agree(runs["2x1"], "nan-rank1")


def test_gather_slots_and_clock_off_a_mesh():
    """Off a mesh the slot gather hands back the rank's block and its
    flag as they are, and the engine's clock is time.perf_counter."""
    import time
    from repro_torch.distributed.steps import gather_slots, shared_clock
    lay = shd.serve_layout((4, 2), 2)
    picks = torch.tensor([3, 5], dtype=torch.int32)
    flag = torch.tensor(True)
    got, f = gather_slots(picks, lay, None, flag=flag)
    assert torch.equal(got, picks) and f is flag
    assert torch.equal(gather_slots(picks, lay, None), picks)
    assert shared_clock(None, "cpu") is time.perf_counter
