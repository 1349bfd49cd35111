"""The port's train step on a mesh: two ranks under gloo on the CPU, against
the port's one-device step and the JAX package's step.

Meshes 2 x 1 (data parallel: the batch cut over the ranks, the gradients
all-reduced), 1 x 2 (model axis: the weights' leaves cut over the ranks,
the fused kernels' sums of squares all-reduced per group of leaves),
2 x 1 with zero3 (weights and moments cut over data, reduce-scattered
gradients), 2 x 1 with ZeRO-1 moments (moments cut over data, the
weights whole: the kernels run on each rank's slice of g and x), and
2 x 2 (both axes, four ranks: what test_torch_cuda_kernels.py runs on
four cards over NCCL). On each,
reduced bert-large with fused_lans, fused_mixed_lans (bf16), fused_lamb
and the unfused lans, and reduced qwen2.5-14b with fused_lans and
microbatches=2, for 3 steps from the bridged JAX params.

Each layout runs in one set of processes (a pair, four for 2 x 2)
started with the spawn method (tests/port/mesh_worker.py), whose
rendezvous is a FileStore under tmp_path; a rank that does not finish in
time fails the test.

The reference is the port's one-device step, with its gradient summed
in the mesh's order where the batch is cut over the two data ranks
(mesh_worker.mesh_order: each rank's block on its own, its means over
the whole batch, then the blocks' gradients added, as the all-reduce
adds them). The maths is one device's; the order of the sums is the
mesh's, so that the gradients agree bit for bit and every element can
be held (mesh_worker.check_against_one_device): fp32 params within rtol
1e-5 and atol 1e-6, and losses within 1e-5, as the fused-vs-unfused step
test (test_torch_train.py) holds them; bf16 (fused_mixed_lans) params
within one bf16 ulp and losses within 1e-4, as test_torch_train.py
holds that transform against the generic wrapper. Each step is held from
the mesh step's own start (params, state and batch), every element of
every leaf; the params after the three steps are held too, every element
but the attention key bias where leaves are cut (its gradient is
rounding noise, mesh_worker says why). The losses are also held to the
plain one-device step's (1e-5; bf16 1e-3) and to the JAX step's on a
1 x 1 mesh (1e-5; bf16 3e-2, bf16 compute in both frameworks, the JAX
package's bf16 tolerance), and the one-device step's fp32 params to the
JAX step's (rtol 1e-5, atol 1e-6; the key bias apart). Planted faults
(an update not applied, a step on half the batch) must fail the
comparison.
"""
import dataclasses
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from port import mesh_worker
from repro.configs import reduced_arch as jreduced
from repro.core.optim import lans as jlans
from repro.core.optim.fused import fused_lamb as jfused_lamb
from repro.core.optim.fused import fused_lans as jfused_lans
from repro.data.corpus import SyntheticCorpus as JCorpus
from repro.data.corpus import mlm_batch_iterator as jmlm
from repro.data.sharding import ShardSpec as JShard
from repro.distributed.steps import build_train_step as jbuild
from repro.distributed.steps import jit_train_step
from repro.launch.mesh import make_local_mesh as jmesh
from repro.precision import get_policy as jpolicy
from repro_torch.bridge import params_from_jax
from repro_torch.core.optim.base import tree_items
from repro_torch.configs import reduced_arch as treduced

STEPS = mesh_worker.STEPS
CASES = mesh_worker.CASES
LAYOUTS = {
    "2x1": dict(data=2, model=1, zero3=False, zero1=False),
    "1x2": dict(data=1, model=2, zero3=False, zero1=False),
    "2x1-zero3": dict(data=2, model=1, zero3=True, zero1=False),
    "2x1-zero1": dict(data=2, model=1, zero3=False, zero1=True),
    "2x2": dict(data=2, model=2, zero3=False, zero1=False),
}
JOIN_S = 300


def _bert_batches(vocab):
    corpus = JCorpus(vocab=vocab, num_docs=256, doc_len=256, seed=0)
    it = jmlm(corpus, JShard(256, 1, 0, 0), per_worker_batch=4, seq_len=32,
              seed=0)
    return [next(it) for _ in range(STEPS)]


def _lm_batches(vocab):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        tok = rng.integers(0, vocab, size=(4, 32)).astype(np.int32)
        lab = np.concatenate([tok[:, 1:], np.full((4, 1), -100, np.int32)],
                             axis=1)
        out.append({"tokens": tok, "labels": lab})
    return out


def _jax_tx(name):
    if name == "fused_lans":
        return jfused_lans(mesh_worker.LR), "fp32"
    if name == "fused_lamb":
        return jfused_lamb(mesh_worker.LR), "fp32"
    # the port's fused_mixed_lans is mixed_precision(lans) fused
    # (test_torch_train.py); the JAX builder wraps lans in it
    return jlans(mesh_worker.LR), ("bf16" if name == "fused_mixed_lans"
                                   else "fp32")


def _jax_run(arch_name, optimizer, microbatches, jparams, batches):
    tx, policy = _jax_tx(optimizer)
    ja = jreduced(arch_name)
    ja = dataclasses.replace(ja, cfg=dataclasses.replace(
        ja.cfg, compute_dtype=jnp.float32 if policy == "fp32"
        else jnp.bfloat16))
    mesh = jmesh(data=1, model=1)
    step, init, specs_for = jbuild(ja.loss_fn, tx, mesh,
                                   microbatches=microbatches,
                                   param_init_fn=lambda _: jparams,
                                   policy=jpolicy(policy))
    params, state = init(None)
    pspec, ospec = specs_for(params, state)
    if optimizer in ("fused_lans", "fused_lamb"):
        # opt_state_pspec iterates a bare FusedState's fields as if it
        # were a chain and returns a plain tuple, which jit then refuses
        # (ROADMAP Queue 3); on a 1 x 1 mesh every spec is P()
        ospec = jax.tree.map(lambda _: P(), state)
    losses = []
    with mesh:
        jitted = None
        for b in batches:
            jb = {k: jnp.asarray(v) for k, v in b.items()}
            if jitted is None:
                jitted = jit_train_step(step, mesh, pspec, ospec, jb)
            params, state, m = jitted(params, state, jb)
            losses.append(float(m["loss"]))
    params = params_from_jax(
        treduced(arch_name).cfg,
        jax.tree.map(lambda a: np.asarray(a, np.float32), params))
    return {"losses": losses,
            "params": dict(tree_items(params))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{layout: {case: rank 0's results}, "one": ..., "jax": ...}: every
    layout's pair started first, the references computed while they run,
    then each pair joined."""
    tmp = tmp_path_factory.mktemp("mesh")
    jparams, tparams = {}, {}
    for name in ("bert-large", "qwen2.5-14b"):
        ja = jreduced(name)
        jparams[name] = jax.jit(ja.init)(jax.random.PRNGKey(0))
        tparams[name] = params_from_jax(treduced(name).cfg,
                                        jax.tree.map(np.asarray,
                                                     jparams[name]))
    np_batches = {
        "bert-large": _bert_batches(jreduced("bert-large").cfg.vocab),
        "qwen2.5-14b": _lm_batches(jreduced("qwen2.5-14b").cfg.vocab)}
    cases = {name: dict(arch=a, optimizer=o, microbatches=mb,
                        batches=[{k: torch.from_numpy(v) for k, v in b.items()}
                                 for b in np_batches[a]])
             for name, (a, o, mb) in CASES.items()}
    inputs = tmp / "inputs.pt"
    torch.save({"params": tparams, "cases": cases}, inputs)

    ctx = multiprocessing.get_context("spawn")
    procs = {lname: mesh_worker.start_ranks(ctx, layout, tmp, inputs, lname)
             for lname, layout in LAYOUTS.items()}
    out = {"one": {}, "order2": {}, "jax": {}}
    threads = torch.get_num_threads()
    # one thread, as each rank runs: a CPU sum's order follows the count
    torch.set_num_threads(1)
    try:
        for name, case in cases.items():
            for key, data in (("one", 1), ("order2", 2)):
                losses, params, *_ = mesh_worker.run_steps(
                    case, tparams[case["arch"]], case["batches"], data=data)
                out[key][name] = {"losses": losses, "params": params}
            out["jax"][name] = _jax_run(case["arch"], case["optimizer"],
                                        case["microbatches"],
                                        jparams[case["arch"]],
                                        np_batches[case["arch"]])
        out["init"] = {name: dict(tree_items(p)) for name, p in
                       tparams.items()}
        out["tparams"], out["cases"] = tparams, cases
    finally:
        torch.set_num_threads(threads)
        for lname, ranks in procs.items():
            out[lname] = mesh_worker.join_ranks(ranks, tmp, lname, JOIN_S)
    return out


def _bf16(case):
    return CASES[case][1] == "fused_mixed_lans"


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_step_matches_one_device(runs, layout, case):
    """Against the one-device step whose gradient is summed in the
    layout's order (the two data ranks' blocks added, where the batch is
    cut), at mesh_worker's tolerances, every step; the losses also
    against the plain one-device step's."""
    got = runs[layout][case]
    want = runs["order2" if LAYOUTS[layout]["data"] > 1 else "one"][case]
    assert len(got["checks"]) == STEPS
    mesh_worker.check_against_one_device(got, want, LAYOUTS[layout], case)
    np.testing.assert_allclose(got["losses"], runs["one"][case]["losses"],
                               rtol=1e-3 if _bf16(case) else 1e-5)


@pytest.mark.parametrize("case", [c for c in CASES if not _bf16(c)])
def test_one_device_params_match_jax(runs, case):
    """The port's one-device step against the JAX step on a 1 x 1 mesh,
    fp32: every element of every leaf within rtol 1e-5 and atol 1e-6
    after the steps, but for the attention key bias, whose gradient is
    rounding noise in both packages (mesh_worker.check_against_one_device
    says why), so that LANS steps it in directions that agree no better
    than a coin (test_torch_train.py:
    test_adamw_bf16_moves_key_bias_on_rounding_noise). The bf16 case is
    held to JAX on its losses: bf16 compute rounds the gradients of the
    two packages apart, and LANS's normalization carries that into the
    small elements' steps."""
    want = runs["jax"][case]["params"]
    mesh_worker.assert_params_close(
        runs["one"][case]["params"], want,
        skip={p for p in want if mesh_worker.key_bias(p)})


@pytest.mark.parametrize("fault", ["no-update", "key-bias-not-updated",
                                   "half-batch", "step-key-bias-1x2"])
def test_mesh_check_catches_planted_faults(runs, fault):
    """The comparison above fails on a run with a planted fault, its
    losses kept so that only the params can show it. On 2 x 1: the
    update never applied (the initial params), the key bias's update
    alone not applied, or each step taken on half the batch (rank 0's
    block alone, as a rank whose gradient was never added to the
    other's). On 1 x 2, whose key bias is held step by step: the key
    bias not updated on any step."""
    case = "bert-fused_lans"
    init = runs["init"]["bert-large"]
    layout = "1x2" if fault == "step-key-bias-1x2" else "2x1"
    got = runs[layout][case]
    if fault == "no-update":
        got = {**got, "params": init}
    elif fault == "key-bias-not-updated":
        got = {**got, "params": {p: init[p] if mesh_worker.key_bias(p)
                                 else v for p, v in got["params"].items()}}
    elif fault == "half-batch":
        half = {**runs["cases"][case],
                "batches": [{k: v[:2] for k, v in b.items()}
                            for b in runs["cases"][case]["batches"]]}
        got = {**got, "params": mesh_worker.run_steps(
            half, runs["tparams"]["bert-large"], half["batches"])[1]}
    else:
        got = {**got, "checks": [
            ({p: init[p] if mesh_worker.key_bias(p) else v
              for p, v in mesh.items()}, ref) for mesh, ref in got["checks"]]}
    want = runs["order2" if layout == "2x1" else "one"][case]
    with pytest.raises(AssertionError):
        mesh_worker.check_against_one_device(got, want, LAYOUTS[layout],
                                             case)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_step_losses_match_jax(runs, layout, case):
    np.testing.assert_allclose(runs[layout][case]["losses"],
                               runs["jax"][case]["losses"],
                               rtol=3e-2 if _bf16(case) else 1e-5)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_partial_allreduces_per_step(runs, layout):
    """The fused optimizers add their sums of squares over the ranks only
    for leaves cut over them: none on 2 x 1 (every leaf whole), and on the
    other layouts one stacked all-reduce per group of cut leaves (here one
    group: model on 1 x 2 and 2 x 2, data under zero3 and ZeRO-1) for
    each of the two reductions of a step (K1's g_sq and K2's norms; K1's
    sums for LAMB's clip and K5's norms). The unfused lans reduces
    through DTensor's own ops and issues none of these."""
    want = 0 if layout == "2x1" else 2
    for case, (_, optimizer, _) in CASES.items():
        calls = runs[layout][case]["calls"]
        assert calls == [0 if optimizer == "lans" else want] * STEPS, case
