"""The dry run (repro_torch/launch/dryrun.py, trace_cost.py) held to what
it stands for:

- FLOP parity with JAX: for reduced bert-large, gemma2-2b and
  granite-moe-3b-a800m on one device in fp32, the matmul FLOPs the port's
  tracer counts for a train step equal the dot and convolution FLOPs of
  the JAX step's optimized HLO, walked loop-aware by
  repro.launch.hlo_cost.HloModule (`_hlo_dot_flops` limits the walk to
  those ops), within 1%;
- the trace is exact: on meta tensors it counts what the same step run on
  real CPU tensors counts (FLOPs by dtype, bytes, collectives and argument
  bytes), its matmul FLOPs equal torch's FlopCounterMode over the real
  step, and a loop folded to two trips counts what every trip counts;
- the argument bytes are the bytes of the live leaves;
- a hand kernel reached on meta tensors is charged its own cost (the
  cost functions beside the kernels), and on the CPU its plain version
  runs uncharged;
- on gloo meshes of 2 x 1 and 1 x 2 (2 x 1 with zero3 and with ZeRO-1 too)
  each rank's dry run, in a fake process group of the layout's ranks,
  counts what the real step counts on that rank (mesh_worker: count_case,
  run_count_rank, dry_counts);
- a few production-shape combinations (meta tensors, a fake 256-rank
  mesh) trace in a few seconds each, and the ZeRO-1 step holds half of
  each data-cut moment on a 2 x 1 mesh.

The dry run takes the process's default process group, so the runs that
need one are made in processes of their own.
"""
import dataclasses
import json
import multiprocessing
import os
import re
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port import mesh_worker
from repro.configs import reduced_arch as jreduced
from repro.core.optim import lans as jlans
from repro.distributed.steps import build_train_step as jbuild
from repro.distributed.steps import jit_train_step
from repro.launch import hlo_cost
from repro.launch.mesh import make_local_mesh as jmesh
from repro_torch.configs import reduced_arch
from repro_torch.core.optim import fused_lamb, fused_lans, lans
from repro_torch.core.optim.base import tree_items
from repro_torch.kernels import lamb as kb
from repro_torch.kernels import lans as kl
from repro_torch.launch import dryrun
from repro_torch.launch.trace_cost import Tracer
from repro_torch.precision import fused_mixed_lans, get_policy

TESTS = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(os.path.dirname(TESTS), "src")
LR = 1e-3
ROWS, SEQ = 4, 32
JOIN_S = 300
LAYOUTS = {
    "2x1": dict(data=2, model=1, zero3=False, zero1=False),
    "1x2": dict(data=1, model=2, zero3=False, zero1=False),
    "2x1-zero3": dict(data=2, model=1, zero3=True, zero1=False),
    "2x1-zero1": dict(data=2, model=1, zero3=False, zero1=True),
}
COMPARED = ("flops_by_dtype", "bytes_accessed", "collective_bytes",
            "collective_counts")


def _batch(arch, rows=ROWS):
    rng = np.random.default_rng(0)
    if arch.kind == "bert":
        tok = rng.integers(0, arch.cfg.vocab, size=(rows, SEQ))
        return {"tokens": tok.astype(np.int32),
                "token_types": np.zeros((rows, SEQ), np.int32),
                "mlm_labels": np.where(rng.random((rows, SEQ)) < 0.15, tok,
                                       -100).astype(np.int32),
                "nsp_labels": rng.integers(0, 2, (rows,)).astype(np.int32)}
    return mesh_worker.lm_batch(rng, arch.cfg, rows)


def _port(name):
    arch = reduced_arch(name)
    return dataclasses.replace(arch, cfg=dataclasses.replace(
        arch.cfg, compute_dtype=torch.float32))


def _matmul(analysis):
    return sum(v for k, v in analysis["flops_by_dtype"].items()
               if k != "elementwise")


# --------------------------------------------------------------------------
# FLOP parity with the JAX step's HLO
# --------------------------------------------------------------------------

def _hlo_dot_flops(mod, comp, memo):
    """hlo_cost.HloModule's loop-aware walk, counting only the FLOPs of
    dot and convolution ops (while bodies times their trip counts,
    fusions and calls through their computations, a conditional's
    largest branch)."""
    if comp in memo:
        return memo[comp]
    memo[comp] = 0.0
    total = 0.0
    for line in mod.computations.get(comp, []):
        m = re.match(r"^(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.*)$", line)
        if not m:
            continue
        rhs = m.group(2)
        op_m = re.search(r"\)?\s*([\w\-]+)\(", rhs)
        op = op_m.group(1) if op_m else ""
        res = hlo_cost._shapes_in(rhs.split(op + "(")[0]) if op else []
        if op == "while":
            body = mod._called(rhs, "body")
            cond = mod._called(rhs, "condition")
            tm = re.search(r'"known_trip_count":\{"n":"(\d+)"\}', rhs)
            trips = (float(tm.group(1)) if tm else
                     mod.trip_count(cond) if cond else 1.0)
            if body:
                total += _hlo_dot_flops(mod, body, memo) * trips
        elif op in ("fusion", "call", "custom-call"):
            called = (mod._called(rhs, "calls") or mod._called(rhs, "to_apply")
                      or mod._called(rhs, "called_computations"))
            if called:
                total += _hlo_dot_flops(mod, called, memo)
        elif op == "conditional":
            branches = (re.findall(r"%([\w.\-]+)", rhs.split("branch")[-1])
                        if "branch" in rhs else [])
            vals = [_hlo_dot_flops(mod, b, memo) for b in branches
                    if b in mod.computations]
            total += max(vals, default=0.0)
        elif op == "dot":
            total += mod._dot_flops(rhs, {}, res)
        elif op == "convolution":
            total += 2.0 * sum(hlo_cost._nelems(d) for _, d in res)
    memo[comp] = total
    return total


@pytest.mark.parametrize("name", ["bert-large", "gemma2-2b",
                                  "granite-moe-3b-a800m"])
def test_matmul_flops_match_the_jax_hlo(name):
    ja = jreduced(name)
    ja = dataclasses.replace(ja, cfg=dataclasses.replace(
        ja.cfg, compute_dtype=jnp.float32))
    mesh = jmesh(data=1, model=1)
    step, init, specs_for = jbuild(ja.loss_fn, jlans(LR), mesh,
                                   param_init_fn=ja.init)
    params, state = init(jax.random.PRNGKey(0))
    pspec, ospec = specs_for(params, state)
    batch = _batch(ja)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with mesh:
        text = jit_train_step(step, mesh, pspec, ospec, jb).lower(
            params, state, jb).compile().as_text()
    mod = hlo_cost.HloModule(text)
    want = _hlo_dot_flops(mod, mod.entry, {})
    got = _matmul(dryrun.trace_train(
        _port(name), {k: torch.from_numpy(v) for k, v in batch.items()},
        tx=lans(LR))[0])
    assert want > 0
    assert abs(got - want) <= 0.01 * want, (got, want)


# --------------------------------------------------------------------------
# the trace is exact on the CPU
# --------------------------------------------------------------------------

EXACT = ["bert-large", "gemma2-2b", "granite-moe-3b-a800m", "mamba2-130m",
         "whisper-large-v3", "jamba-1.5-large-398b"]


@pytest.mark.parametrize("name", EXACT)
def test_meta_trace_equals_the_real_step(name):
    arch = _port(name)
    batch = {k: torch.from_numpy(v) for k, v in _batch(arch).items()}
    meta, _ = dryrun.trace_train(arch, batch, tx=lans(LR))
    real, _ = dryrun.trace_train(arch, batch, tx=lans(LR),
                                 gen=torch.Generator().manual_seed(0))
    for key in COMPARED:
        assert meta[key] == real[key], key
    assert meta["memory_analysis"]["argument_size_in_bytes"] == \
        real["memory_analysis"]["argument_size_in_bytes"]
    # torch's own counter over the same step on real tensors
    from repro_torch.distributed.steps import build_train_step
    step, init = build_train_step(arch.loss_fn, lans(LR),
                                  param_init_fn=arch.init)
    params, state = init(torch.Generator().manual_seed(0))
    counter = FlopCounterMode(display=False)
    with counter:
        step(params, state, batch)
    assert _matmul(meta) == counter.get_total_flops()


@pytest.mark.parametrize("name,mb", [("bert-large", 4), ("gemma2-2b", 3),
                                     ("granite-moe-3b-a800m", 4)])
def test_folded_loop_counts_every_trip(name, mb):
    arch = _port(name)
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(arch, rows=2 * mb).items()}
    folded, t_fold = dryrun.trace_train(arch, batch, microbatches=mb,
                                        tx=lans(LR), fold_loops=True)
    every, t_all = dryrun.trace_train(arch, batch, microbatches=mb,
                                      tx=lans(LR), fold_loops=False)
    for key in COMPARED:
        assert folded[key] == every[key], key
    # the folded trace ran two of the trips
    assert len(t_fold.by_op) == len(t_all.by_op)
    assert t_fold.by_op["aten::mm"][0] == t_all.by_op["aten::mm"][0]


def _leaf_bytes(tree):
    from torch.utils._pytree import tree_flatten
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


@pytest.mark.parametrize("tx_name", ["lans", "fused_lans", "fused_lamb"])
def test_argument_bytes_are_the_live_leaves(tx_name):
    from repro_torch.distributed.steps import build_train_step
    arch = _port("bert-large")
    tx = {"lans": lans, "fused_lans": fused_lans,
          "fused_lamb": fused_lamb}[tx_name](LR)
    batch = {k: torch.from_numpy(v) for k, v in _batch(arch).items()}
    meta, _ = dryrun.trace_train(arch, batch, tx=tx)
    _, init = build_train_step(arch.loss_fn, tx, param_init_fn=arch.init)
    params, state = init(torch.Generator().manual_seed(0))
    live = _leaf_bytes(params) + _leaf_bytes(state) + _leaf_bytes(batch)
    assert meta["memory_analysis"]["argument_size_in_bytes"] == live
    assert meta["memory_analysis"]["temp_size_in_bytes"] > 0


# --------------------------------------------------------------------------
# hand kernels on meta tensors
# --------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["fused_lans", "fused_lamb",
                                   "fused_mixed_lans"])
def test_kernel_stand_ins_charge_their_own_cost(route):
    arch = _port("bert-large")
    policy = None
    if route == "fused_mixed_lans":
        policy = get_policy("bf16")
        arch = dataclasses.replace(arch, cfg=policy.apply_to_cfg(arch.cfg))
        tx = fused_mixed_lans(LR, policy)
    else:
        tx = {"fused_lans": fused_lans, "fused_lamb": fused_lamb}[route](LR)
    batch = {k: torch.from_numpy(v) for k, v in _batch(arch).items()}
    analysis, tracer = dryrun.trace_train(arch, batch, tx=tx, policy=policy)
    want = {"fused_lans": ("sq_norm", "lans_phase1", "lans_phase2"),
            "fused_lamb": ("sq_norm", "lamb_phase1", "lamb_phase2"),
            "fused_mixed_lans": ("sq_norm", "lans_phase1",
                                 "lans_phase2_cast")}[route]
    items = tree_items(arch.abstract_params())
    assert analysis["kernels"] == {k: len(items) for k in want}
    # the kernels' own cost, leaf by leaf: fp32 gradients and masters, the
    # model copy in the policy's dtype for the leaf
    f32 = [(p, torch.empty(t.shape, device="meta")) for p, t in items]
    lp = (lambda p: policy.leaf_dtype(p)) if policy else (lambda p: None)
    costs = {"sq_norm": lambda p, t: kl.sq_norm_cost(t),
             "lans_phase1": lambda p, t: kl.lans_phase1_cost(t, t),
             "lans_phase2": lambda p, t: kl.lans_phase2_cost(t, t),
             "lans_phase2_cast": lambda p, t: kl.lans_phase2_cost(
                 t, t, lp(p)),
             "lamb_phase1": lambda p, t: kb.lamb_phase1_cost(t, t),
             "lamb_phase2": lambda p, t: kb.lamb_phase2_cost(t)}
    for k in want:
        assert tracer.by_op[f"kernel::{k}"] == [
            float(sum(costs[k](p, t)[0] for p, t in f32)),
            float(sum(costs[k](p, t)[1] for p, t in f32))], k
    if policy is None:
        per_param = sum(tracer.by_op[f"kernel::{k}"][1] for k in want) / sum(
            t.numel() for _, t in f32)
        assert per_param == {"fused_lans": 48, "fused_lamb": 44}[route]


def test_stand_in_only_on_meta():
    g = torch.randn(64)
    with Tracer() as t:
        kl.sq_norm(g)
    assert t.cost.kernels == {}
    with Tracer() as t:
        out = kl.sq_norm(torch.empty(64, device="meta"))
    assert t.cost.kernels == {"sq_norm": 1.0} and out.device.type == "meta"
    assert t.cost.bytes == 256


# --------------------------------------------------------------------------
# per-rank counts on gloo meshes
# --------------------------------------------------------------------------

def _in_own_process(code, timeout=600):
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([SRC, TESTS])}
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout.strip().splitlines()[-1]


@pytest.fixture(scope="module")
def counted(tmp_path_factory):
    """({layout: [rank's {case: record}]} of the real gloo runs, the same
    of the dry run)."""
    tmp = tmp_path_factory.mktemp("count")
    ctx = multiprocessing.get_context("spawn")
    procs = {}
    for name, layout in LAYOUTS.items():
        world = layout["data"] * layout["model"]
        procs[name] = [ctx.Process(target=mesh_worker.run_count_rank, args=(
            r, world, str(tmp / f"store-{name}"), layout,
            str(tmp / f"out-{name}"))) for r in range(world)]
        for p in procs[name]:
            p.start()
    path = tmp / "dry.pt"
    _in_own_process(f"""
        import torch
        from port import mesh_worker
        torch.set_num_threads(1)
        torch.save(mesh_worker.dry_counts({LAYOUTS!r}), {str(path)!r})
        print("done")
    """)
    real = {}
    try:
        for name, ranks in procs.items():
            for p in ranks:
                p.join(JOIN_S)
            codes = [p.exitcode for p in ranks]
            assert codes == [0] * len(ranks), f"{name}: exit codes {codes}"
            real[name] = [torch.load(tmp / f"out-{name}.{r}")
                          for r in range(len(ranks))]
    finally:
        for ranks in procs.values():
            for p in ranks:
                if p.is_alive():
                    p.kill()
                    p.join()
    return real, torch.load(path)


@pytest.mark.parametrize("case", list(mesh_worker.COUNT_CASES))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_dry_run_counts_what_each_rank_runs(counted, layout, case):
    """FLOPs by dtype, collective bytes and counts by kind, argument
    bytes. Not the bytes moved: gloo completes a reduce-scatter with a
    copy of its own into the output, which the fake backend does not
    make (the one-device test above holds the bytes exactly)."""
    real, dry = counted
    for rank, (got, want) in enumerate(zip(dry[layout], real[layout])):
        for key in ("flops_by_dtype", "collective_bytes",
                    "collective_counts"):
            assert got[case][key] == want[case][key], (rank, key)
        assert (got[case]["memory_analysis"]["argument_size_in_bytes"] ==
                want[case]["memory_analysis"]["argument_size_in_bytes"])
    coll = dry[layout][0][case]["collective_bytes"]
    if LAYOUTS[layout]["zero3"] or LAYOUTS[layout]["zero1"]:
        assert coll["reduce-scatter"] > 0
    if layout == "1x2":
        assert coll["all-gather"] > 0      # the rank-order sums


# --------------------------------------------------------------------------
# production shapes and ZeRO-1 on meta tensors
# --------------------------------------------------------------------------

COMBOS = [("mamba2-130m", "decode_32k", False, "xla"),
          ("gemma2-2b", "decode_32k", False, "paged"),
          ("whisper-large-v3", "decode_32k", False, "xla"),
          ("mamba2-130m", "long_500k", True, "xla"),
          ("bert-large", "prefill_32k", False, "xla")]


@pytest.fixture(scope="module")
def production():
    return json.loads(_in_own_process(f"""
        import json, time
        import torch
        from repro_torch.launch import dryrun
        out = []
        for arch, shape, pod, kern in {COMBOS!r}:
            t0 = time.time()
            rec = dryrun.run_one(arch, shape, pod, kern)
            rec["wall_s"] = time.time() - t0
            out.append(rec)
        print(json.dumps(out, default=str))
    """))


@pytest.mark.parametrize("i", range(len(COMBOS)))
def test_production_shapes_trace_in_seconds(production, i):
    arch, shape, pod, kern = COMBOS[i]
    rec = production[i]
    if arch == "bert-large":
        assert (rec["status"], rec["reason"]) == (
            "skipped", "bert has no prefill step")
        return
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["wall_s"] < 30
    assert rec["n_chips"] == (512 if pod else 256)
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    r = rec["roofline"]
    assert r["bound_s"] == max(r["compute_s"], r["memory_s"],
                               r["collective_s"])
    if kern == "paged":
        # K8's stand-in, once per attention layer of the decode step
        assert rec["kernels"] == {"paged_attention_fused": 26}
        assert rec["flops_by_dtype"]["float32"] > 0
    else:
        assert rec["kernels"] == {}


def test_zero1_holds_half_of_each_data_cut_moment():
    got = json.loads(_in_own_process("""
        import json
        import torch
        from repro_torch.configs import reduced_arch
        from repro_torch.core.optim import lans
        from repro_torch.core.optim.base import tree_items
        from repro_torch.distributed import sharding as shd
        from repro_torch.distributed.steps import build_train_step
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import make_local_mesh
        arch = reduced_arch("qwen2.5-32b")
        assert arch.zero1
        with dryrun.fake_world(2, 0):
            mesh = make_local_mesh(data=2, model=1, device="cpu")
            step, init = build_train_step(
                arch.loss_fn, lans(1e-3), mesh, zero1=True,
                param_init_fn=arch.init, heads=arch.heads)
            with torch.device("meta"):
                p, o = init(None)
            pspec, ospec = step.specs_for(p, o)
            cuts = dict(tree_items(shd.params_pspec(p, mesh, zero3=True)))
            p = shd.distribute(p, mesh, pspec)
            o = shd.distribute(o, mesh, ospec)
            out = {"params": [], "mu": []}
            for path, t in tree_items(p):
                out["params"].append([path, t.to_local().numel(), t.numel()])
            for path, t in tree_items(o[0].mu):
                out["mu"].append([path, t.to_local().numel(), t.numel(),
                                  "data" in repr(cuts[path])])
        print(json.dumps(out))
    """))
    assert all(local == whole for _, local, whole in got["params"])
    cut = [(local, whole) for _, local, whole, c in got["mu"] if c]
    assert len(cut) >= len(got["mu"]) // 2
    assert all(2 * local == whole for local, whole in cut)
    assert all(local == whole for _, local, whole, c in got["mu"] if not c)


def test_decode_trace_cuts_experts_vocab_and_mamba_heads():
    """Reduced jamba's decode step (decode_32k's batch and rings, meta
    tensors) on a fake 1 x 2 mesh against one device: rank 0's argument
    bytes of its expert stacks, vocab table and Mamba out_proj are half
    of one device's, of its in_proj and conv_w its heads' columns (B and
    C whole), and the trace's argument bytes are the placed leaves' plus
    a cache cut too (half the KV heads and the SSM state's heads)."""
    got = json.loads(_in_own_process("""
        import json
        import torch
        from repro_torch.configs import SHAPES, reduced_arch
        from repro_torch.core.optim.base import tree_items
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import make_local_mesh
        arch = reduced_arch("jamba-1.5-large-398b")
        out = {}
        for model in (1, 2):
            with dryrun.fake_world(model, 0):
                mesh = make_local_mesh(data=1, model=model, device="cpu")
                analysis, _ = dryrun.trace_decode(arch, SHAPES["decode_32k"],
                                                  mesh)
                params = dryrun._serve_params(arch, mesh)
                out[model] = {
                    "args": analysis["memory_analysis"][
                        "argument_size_in_bytes"],
                    "leaves": {p: [list(t.shape), t.numel() * t.element_size()]
                               for p, t in tree_items(params)}}
        print(json.dumps(out))
    """))
    from repro_torch.distributed.sharding import (mamba_segments,
                                                  segment_columns)
    arch = reduced_arch("jamba-1.5-large-398b")
    one, two = got["1"]["leaves"], got["2"]["leaves"]
    kinds = {"expert": 0, "vocab": 0, "out_proj": 0, "columns": 0}
    for path, (shape, nbytes) in one.items():
        parts = path.split("/")
        local_shape, local = two[path]
        if parts[-1] in ("up", "gate", "down"):
            kind = "expert"
        elif path == "embed/embedding":
            kind = "vocab"
        elif parts[-2:] == ["out_proj", "kernel"]:
            kind = "out_proj"
        elif parts[-2:] == ["in_proj", "kernel"] or parts[-1] == "conv_w":
            leaf = "conv_w" if parts[-1] == "conv_w" else "in_proj"
            cols = len(segment_columns(mamba_segments(leaf, arch.mamba, 2),
                                       2, 0))
            assert local_shape[-1] == cols < shape[-1], path
            assert local * shape[-1] == nbytes * cols
            kinds["columns"] += 1
            continue
        else:
            continue
        assert 2 * local == nbytes, path
        kinds[kind] += 1
    assert all(kinds.values()), kinds
    params = {m: sum(b for _, b in got[m]["leaves"].values())
              for m in ("1", "2")}
    # the cache: 8 periods' worth of state cut to half its heads, the
    # attention arena to half its KV heads, the inputs whole
    rest = {m: got[m]["args"] - params[m] for m in ("1", "2")}
    assert 0 < rest["2"] < rest["1"]
    assert got["2"]["args"] < got["1"]["args"]


def test_decode_trace_cuts_attention_in_head_groups():
    """Reduced qwen2.5-14b's decode step (decode_32k's batch and rings,
    meta tensors) on a fake 1 x 4 mesh, whose 4 heads and 2 KV heads it
    cuts in two head groups (distributed/sharding.py: head_groups),
    against one device: rank 0's wq / wk / wv bytes are exactly 1/2 of
    one device's, its wo bytes 1/4, its K/V arena bytes 1/2, and the
    trace's argument bytes fall by exactly what the params and the K/V
    arenas lose: the cache's positions, the tables and the inputs are
    unchanged."""
    got = json.loads(_in_own_process("""
        import json
        from repro_torch.configs import SHAPES, reduced_arch
        from repro_torch.core.optim.base import tree_items
        from repro_torch.distributed import sharding as shd
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import make_local_mesh
        arch = reduced_arch("qwen2.5-14b")
        shape = SHAPES["decode_32k"]
        out = {}
        for model in (1, 4):
            with dryrun.fake_world(model, 0):
                mesh = make_local_mesh(data=1, model=model, device="cpu")
                analysis, _ = dryrun.trace_decode(arch, shape, mesh)
                params = dryrun._serve_params(arch, mesh)
                layout = shd.serve_layout(arch.heads, shape.global_batch,
                                          mesh, arch.mamba)
                cache = arch.paged_cache_specs(
                    shape.name, batch=shape.global_batch, layout=layout)
                kv = sum(t.numel() * t.element_size()
                         for s in cache["slots"] for k, t in s.items()
                         if k in ("k", "v"))
                out[model] = {
                    "args": analysis["memory_analysis"][
                        "argument_size_in_bytes"], "kv": kv,
                    "leaves": {p: t.numel() * t.element_size()
                               for p, t in tree_items(params)}}
        print(json.dumps(out))
    """))
    one, four = got["1"], got["4"]
    share = {"wq": 2, "wk": 2, "wv": 2, "wo": 4}
    seen = set()
    for path, nbytes in one["leaves"].items():
        parts = path.split("/")
        if parts[-1] == "kernel" and parts[-2] in share:
            assert four["leaves"][path] * share[parts[-2]] == nbytes, path
            seen.add(parts[-2])
    assert seen == set(share)
    assert four["kv"] * 2 == one["kv"]
    lost = (sum(one["leaves"].values()) - sum(four["leaves"].values())
            + one["kv"] - four["kv"])
    assert one["args"] - four["args"] == lost
