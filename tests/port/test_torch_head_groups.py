"""Attention cut over "model" in head groups where the model size does
not divide the heads (distributed/sharding.py: head_groups, use_plan's
"heads"), held on the CPU under gloo, against the one-device step and
engine and the JAX package's step:

  * the rule, a pure function: for every assigned arch on a model axis
    of 2, 4, 8 and 16 ranks, d = gcd(model, n_heads, n_kv); the ranks
    [g m / d, (g + 1) m / d) hold, placed by serve_params, the columns of
    wq / wk / wv of the whole q heads [g h / d, (g + 1) h / d) and KV
    heads [g kv / d, (g + 1) kv / d), GQA's map inside the group, and
    each rank its m-th of wo's rows; d == m is the whole-head split;
  * training on 1 x 4 (reduced qwen2.5-14b, with QKV biases and two
    microbatches, and gemma2-2b: n_heads 4, n_kv 2, so d = 2, groups of
    two ranks), fused_lans, 3 steps, four gloo ranks: every step's
    params, gradient and update within mesh_worker's tolerances of the
    one-device step that computes each rank's group and rows as the
    ranks do (mesh_worker.model_split: split_attention), the losses
    within 1e-5 of the plain one-device step's and (qwen) of the JAX
    step's on a 1 x 1 mesh; the fetch gathers wq / wk / wv over groups of two
    ranks only, at a group's columns, and nothing over all four (wo is
    never gathered); a wq bias gradient left as one group's fails the
    comparison;
  * serving on 1 x 4: reduced qwen2.5-14b (gather and K8's path),
    whisper-large-v3 and BERT scoring with two heads (d = 2), and
    run_one, equal to one device's tokens (BERT's ids, its pooled
    vectors within rtol 1e-4, atol 1e-6); each rank's K/V arena bytes
    and wq / wk / wv bytes exactly 1/2 of one device's, wo's 1/4, the
    arena shapes the whole cut as serve_pspec says (its Groups entry);
    K8's plain version handed the local arena tiled to the global
    KV-head count fails the comparison.

Each part runs its ranks in one set of processes started with the spawn
method over a FileStore under tmp_path (tests/port/mesh_worker.py,
serve_worker.py); the references run here meanwhile, on one CPU thread
as each rank.
"""
import dataclasses
import math
import multiprocessing
import types

import jax
import numpy as np
import pytest
import torch

from port import mesh_worker
from port import serve_worker as sw
from port.test_torch_mesh_train import _jarch, _jax_run, _lm_batches
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ASSIGNED, get_arch, reduced_arch
from repro_torch.core.optim.base import tree_items
from repro_torch.distributed import sharding as shd

LAYOUT = dict(data=1, model=4, zero3=False, zero1=False)
TRAIN_CASES = ("qwen-fused_lans", "gemma2-fused_lans")
# held to the JAX step too (its QKV biases, two microbatches): one JAX
# compile, which is most of this file's time
JAX_CASES = ("qwen-fused_lans",)
# serving case -> the one-device case it must equal
SERVE_CASES = {"fp32": "fp32", "kernel-fp32": "kernel-fp32",
               "whisper-h2": "whisper-h2", "bert-h2": "bert-h2",
               "one-fp32": "fp32"}
FAULT = ("fault-global-kv", "kernel-fp32")
JOIN_S = 300


class _Rank:
    """A stand-in mesh of one rank of a 1 x m mesh: what the rules and
    serve_params read of a DeviceMesh."""

    def __init__(self, m, k):
        self.shape = (1, m)
        self.mesh_dim_names = ("data", "model")
        self._coord = (0, k)

    def get_coordinate(self):
        return self._coord


def _tiny(h, kv, hd):
    """One stacked layer of attention whose entries count their column
    (wq / wk / wv) or row (wo), d_model 1: which ones a rank holds."""
    col = lambda n: torch.arange(n, dtype=torch.float32).reshape(1, 1, n)
    return {"layers": {"attn": {
        "wq": {"kernel": col(h * hd)}, "wk": {"kernel": col(kv * hd)},
        "wv": {"kernel": col(kv * hd)},
        "wo": {"kernel": col(h * hd).reshape(1, h * hd, 1)}}}}


@pytest.mark.parametrize("model", [2, 4, 8, 16])
@pytest.mark.parametrize("arch", [*ASSIGNED, "bert-large"])
def test_head_groups_rule(arch, model):
    heads = get_arch(arch).heads
    h, kv, hd = heads
    d = shd.head_groups(heads, model)
    assert d == math.gcd(model, h, kv) and d >= 2
    mesh = types.SimpleNamespace(shape={"data": 1, "model": model})
    for leaf in ("wq", "wk", "wv", "wo"):
        path = f"layers/attn/{leaf}/kernel"
        use = shd.use_plan(path, shd.PSpec(None, None, "model")
                           if leaf != "wo" else
                           shd.PSpec(None, "model", None), mesh, heads)
        want = ("row" if leaf == "wo" else "col" if d == model
                else "heads")
        assert use.kind == want, (leaf, use)
        assert use.groups == (d if want == "heads" else 0)
    r = model // d
    for k in range(model):
        g = k // r
        got = shd.serve_params(_tiny(h, kv, hd), _Rank(model, k), heads)
        attn = {n: got["layers"]["attn"][n]["kernel"].flatten().long()
                for n in ("wq", "wk", "wv", "wo")}
        q_heads = range(g * h // d, (g + 1) * h // d)
        kv_heads = range(g * kv // d, (g + 1) * kv // d)
        assert attn["wq"].tolist() == [c for q in q_heads
                                       for c in range(q * hd, (q + 1) * hd)]
        for n in ("wk", "wv"):
            assert attn[n].tolist() == [c for j in kv_heads
                                        for c in range(j * hd,
                                                       (j + 1) * hd)]
        # GQA: each q head's KV head lies in the group
        assert {q // (h // kv) for q in q_heads} == set(kv_heads)
        rows = h * hd // model
        assert attn["wo"].tolist() == list(range(k * rows, (k + 1) * rows))


def test_head_groups_need_all_four_kernels_cut():
    """No model axis, or a head_dim that leaves a kernel's columns
    indivisible: no head groups (attention gathered); d = 1 where the
    four are cut but no head count shares a factor with the model size."""
    assert shd.head_groups((8, 4, 256), 1) == 0
    assert shd.head_groups(None, 4) == 0
    assert shd.head_groups((4, 1, 2), 4) == 0      # wk: 2 columns
    assert shd.head_groups((4, 1, 64), 2) == 1     # reduced qwen, kv 1
    assert shd.head_groups((20, 20, 64), 16) == 4  # whisper


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"train": rank 0's results, "serve": every rank's, "one": the
    one-device references, "jax": the JAX step's losses}."""
    tmp = tmp_path_factory.mktemp("groups")
    jparams, tparams, np_batches = {}, {}, {}
    archs = dict.fromkeys(mesh_worker.ALL_CASES[c][0] for c in TRAIN_CASES)
    for name in archs:
        ja = _jarch(name)
        jparams[name] = jax.jit(ja.init)(jax.random.PRNGKey(0))
        tparams[name] = params_from_jax(mesh_worker.reduced(name).cfg,
                                        jax.tree.map(np.asarray,
                                                     jparams[name]))
        np_batches[name] = _lm_batches(ja.cfg)
    cases = {c: dict(arch=a, optimizer=o, microbatches=mb,
                     batches=[{k: torch.from_numpy(v) for k, v in b.items()}
                              for b in np_batches[a]])
             for c, (a, o, mb) in ((c, mesh_worker.ALL_CASES[c])
                                   for c in TRAIN_CASES)}
    train_in = tmp / "train.pt"
    torch.save({"params": tparams, "cases": cases}, train_in)
    names = [*SERVE_CASES, FAULT[0]]
    refs = sorted({*SERVE_CASES.values(), FAULT[1]})
    sparams = {a: sw.reduced(a).init(torch.Generator().manual_seed(0))
               for a in {sw.CASES[c]["arch"] for c in names}}
    serve_in = tmp / "serve.pt"
    torch.save(sparams, serve_in)
    ctx = multiprocessing.get_context("spawn")
    train = mesh_worker.start_ranks(ctx, LAYOUT, tmp, train_in, "train")
    serve = sw.start(ctx, sw.run_rank, 4, tmp, "serve", sw.LAYOUTS["1x4"],
                     names, str(serve_in))
    out = {"one": {}, "order": {}, "jax": {}}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for c in refs:
            out["one"][c] = sw.run_case(c, sparams)
        for name, case in cases.items():
            params = tparams[case["arch"]]
            for key, kw in (("order", dict(model=4)), ("plain", {})):
                losses, got, *_ = mesh_worker.run_steps(
                    case, params, case["batches"], **kw)
                out.setdefault(key, {})[name] = {"losses": losses,
                                                 "params": got}
            if name in JAX_CASES:
                out["jax"][name] = _jax_run(
                    case["arch"], case["optimizer"], case["microbatches"],
                    jparams[case["arch"]], np_batches[case["arch"]])["losses"]
    finally:
        torch.set_num_threads(threads)
        out["train"] = mesh_worker.join_ranks(train, tmp, "train", JOIN_S)
        out["serve"] = sw.join(serve, tmp, "serve", JOIN_S)
    return out


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_group_training_matches_one_device(runs, case):
    got = runs["train"][case]
    assert len(got["checks"]) == mesh_worker.STEPS
    mesh_worker.check_against_one_device(got, runs["order"][case], LAYOUT,
                                         case)
    np.testing.assert_allclose(got["losses"], runs["plain"][case]["losses"],
                               rtol=1e-5)


@pytest.mark.parametrize("case", JAX_CASES)
def test_group_training_losses_match_jax(runs, case):
    """The 1 x 4 losses against the JAX step's on a 1 x 1 mesh from the
    same bridged params (1e-5, as test_torch_mesh_train.py)."""
    np.testing.assert_allclose(runs["train"][case]["losses"],
                               runs["jax"][case], rtol=1e-5)


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_group_training_gathers_only_groups(runs, case):
    """A rank gathers wq / wk / wv over its group of two ranks, at the
    group's columns, and nothing over all four: wo, the MLP and the
    vocab are used as the rank's shards."""
    cfg = mesh_worker.reduced(mesh_worker.ALL_CASES[case][0]).cfg
    hd = cfg.resolved_head_dim
    d = shd.head_groups((cfg.n_heads, cfg.n_kv_heads, hd), 4)
    assert d == 2
    want = {((cfg.d_model, n * hd // d), (4 // d,))
            for n in (cfg.n_heads, cfg.n_kv_heads)}
    assert {(tuple(s), tuple(g)) for s, g in
            runs["train"][case]["gathered"]} == want


def test_group_check_catches_an_unsummed_bias(runs):
    """The comparison fails on the gradient of wq's bias left as the
    first group's part: the other group's half zero."""
    got = runs["train"]["qwen-fused_lans"]
    bias = "slot0/mixer/wq/bias"

    def unsummed(g):
        g = g.clone()
        g[..., g.shape[-1] // 2:] = 0
        return g
    bad = {**got, "checks": [
        {**c, "grads": {**c["grads"], bias: unsummed(c["grads"][bias])}}
        for c in got["checks"]]}
    assert bias in got["checks"][0]["grads"]
    with pytest.raises(AssertionError):
        mesh_worker.check_against_one_device(
            bad, runs["order"]["qwen-fused_lans"], LAYOUT, "qwen-fused_lans")


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_group_serving_equals_one_device(runs, case):
    want = runs["one"][SERVE_CASES[case]]
    assert sw.ranks_agree(runs["serve"], case)
    for rank in runs["serve"]:
        got = rank[case]
        assert sw.same_tokens(got["tokens"], want["tokens"])
        assert got["report"]["mesh_devices"] == 4
        for x, y in zip(want["embeddings"], got["embeddings"]):
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_allclose(y, x, rtol=1e-4, atol=1e-6)


def test_group_serving_planted_fault_fails(runs):
    got = runs["serve"][0][FAULT[0]]["tokens"]
    assert not sw.same_tokens(got, runs["one"][FAULT[1]]["tokens"])


@pytest.mark.parametrize("case", ["kernel-fp32", "whisper-h2", "bert-h2"])
def test_group_rank_holds_its_share(runs, case):
    """A rank's K/V arena (whisper: its self and cross K/V) and wq / wk /
    wv bytes are exactly half of one device's, wo's a quarter; every
    other attention leaf whole; the local arena shapes are the whole cut
    as serve_pspec's Groups("model", 2) entry cuts it."""
    one = runs["one"][case]
    arch = sw.case_arch(case)
    standin = types.SimpleNamespace(shape={"data": 1, "model": 4})
    numel = lambda s: math.prod(s)
    for rank in runs["serve"]:
        got = rank[case]
        for path, shape in one["params"].items():
            leaf = path.split("/")
            if leaf[-1] != "kernel" or leaf[-2] not in ("wq", "wk", "wv",
                                                        "wo"):
                continue
            share = 4 if leaf[-2] == "wo" else 2
            assert numel(got["params"][path]) * share == numel(shape), path
        kv = {k: v for k, v in got["shapes"].items()
              if k.rsplit("/", 1)[-1] in ("k", "v")}
        assert kv or arch.kind == "bert"
        for path, (shape, nbytes) in kv.items():
            oshape, obytes = one["shapes"][path]
            assert nbytes * 2 == obytes, path
            like = types.SimpleNamespace(shape=oshape, ndim=len(oshape),
                                         dtype=torch.bfloat16)
            spec = shd.serve_pspec({"k": like}, standin, arch.heads)["k"]
            assert spec[-2] == shd.Groups("model", 2), spec
            assert tuple(shape) == tuple(
                w // (e.n if isinstance(e, shd.Groups) else 1)
                for w, e in zip(oshape, spec)), (path, spec)


def test_serve_pspec_and_layout_off_the_groups():
    """d == m keeps "model" on the KV heads, d == 0 (no cut) leaves them
    whole; slots that do not divide over "data" are whole on it, in
    serve_pspec and in ServeLayout alike."""
    arch = reduced_arch("qwen2.5-14b")       # heads (4, 2, 64)
    cache = arch.init_paged_cache(4, 32, block_size=8, n_blocks={0: 15},
                                  device="meta")
    for model, entry in ((2, "model"), (4, shd.Groups("model", 2))):
        mesh = types.SimpleNamespace(shape={"data": 2, "model": model})
        spec = shd.serve_pspec(cache, mesh, arch.heads, slots=4)
        assert spec == shd.serve_pspec(cache, mesh, arch.heads)
        assert tuple(spec["slots"][0]["k"]) == (None, "data", None, entry,
                                                None)
        assert tuple(spec["tables"][0]) == ("data", None)
        spec = shd.serve_pspec(cache, mesh, arch.heads, slots=3)
        assert tuple(spec["slots"][0]["k"]) == (None, None, None, entry,
                                                None)
        assert tuple(spec["tables"][0]) == (None, None)
    kv1 = dataclasses.replace(arch, cfg=dataclasses.replace(
        arch.cfg, n_kv_heads=1, head_dim=2))
    mesh = types.SimpleNamespace(shape={"data": 1, "model": 4})
    assert shd.serve_pspec(cache, mesh, kv1.heads)["slots"][0]["k"][-2] \
        is None
    lay = shd.serve_layout(arch.heads, 3, _Rank2x1(1))
    assert (lay.data, lay.data_rank, lay.block, lay.rows, lay.lo) == (
        1, 0, 3, 3, 0)
    assert all(lay.owns(s) for s in range(3))
    lay = shd.serve_layout(arch.heads, 4, _Rank2x1(1))
    assert (lay.data, lay.data_rank, lay.block, lay.lo) == (2, 1, 2, 2)


class _Rank2x1(_Rank):
    """Data rank `k` of a 2 x 1 mesh."""

    def __init__(self, k):
        self.shape = (2, 1)
        self.mesh_dim_names = ("data", "model")
        self._coord = (k, 0)
