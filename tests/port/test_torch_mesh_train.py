"""The port's train step on a mesh: two ranks under gloo on the CPU,
against the port's one-device step and the JAX package's step.

Meshes 2 x 1 (data parallel: the batch cut over the ranks, the gradients
all-reduced), 1 x 2 (model axis: the weights' leaves cut over the ranks,
the fused kernels' sums of squares all-reduced per group of leaves), 2 x
1 with zero3 (weights and moments cut over data, reduce-scattered
gradients), 2 x 1 with ZeRO-1 moments (moments cut over data, the
weights whole: the kernels run on each rank's slice of g and x), and 2 x
2 (both axes, four ranks: what test_torch_cuda_kernels.py runs on four
cards over NCCL). On each, reduced bert-large with fused_lans,
fused_mixed_lans (bf16), fused_lamb, the unfused lans and the unfused
adamw, reduced qwen2.5-14b with fused_lans and microbatches=2, and with
fused_lans reduced granite-moe-3b-a800m (MoE: a rank's block routes as
its group), whisper-large-v3, mamba2-130m and qwen2.5-14b with one KV
head (the model axis cannot split a head, so attention runs in one head
group of both ranks, wq / wk / wv gathered and wo on each rank's rows;
the MLP split), for 3 steps from the bridged JAX params. On 1 x 2 the model
axis also splits the vocab (every case's embedding and readout:
qwen2.5-14b's untied lm_head, BERT's tied MLM head with its bias,
whisper's decoder embedding), MoE experts (granite-moe) and Mamba-2
mixers (mamba2), and 1 x 2 alone runs mesh_worker.SPLIT_CASES: reduced
jamba-1.5-large-398b (experts over "model", Mamba-2 on whole heads),
gemma2-2b (tied, soft-capped readout), gemma2-2b through chunked_lm_loss
at a chunk of 16 positions, and granite-moe with five experts (cut on
their ff dim).

Each layout runs in one set of processes (a pair, four for 2 x 2)
started with the spawn method (tests/port/mesh_worker.py), whose
rendezvous is a FileStore under tmp_path; a rank that does not finish in
time fails the test.

The reference is the port's one-device step, with its gradient summed in
the mesh's order (mesh_worker.mesh_order: each data rank's block on its
own, its means over the whole batch, then the blocks' gradients added,
as the all-reduce adds them, or per microbatch for the leaves zero3
reduce-scatters; MoE routing each block as its group; on a layout with a
model axis the attention and MLP matmuls, the vocab, the experts and the
Mamba-2 mixers split as its ranks split them, their parts added in rank
order in fp32, as distributed/partial.py adds them:
mesh_worker.model_split). The maths is one device's; the order of the
sums is the mesh's, so that the gradients agree bit for bit and every
element can be held (mesh_worker.check_against_one_device): fp32 params
within rtol 1e-5 and atol 1e-6, and losses within 1e-5, as the
fused-vs-unfused step test (test_torch_train.py) holds them; bf16
(fused_mixed_lans) params within one bf16 ulp and losses within 1e-4, as
test_torch_train.py holds that transform against the generic wrapper.
Each step is held from the mesh step's own start (params, state and
batch), every element of every leaf; the params after the three steps
are held too, every element but the attention key bias where leaves are
cut (its gradient is rounding noise, mesh_worker says why). A layout
with a model axis is also held, each step, by its gradient (every
element within rtol 1e-5, atol 1e-6 of the reference's) and by its
update (within 2e-5, bf16 one ulp, of the one-device optimizer's on the
mesh's own gradient). The losses are also held to the plain one-device
step's (1e-5; bf16 1e-3) and to the JAX step's on a 1 x 1 mesh (1e-5;
bf16 3e-2, bf16 compute in both frameworks, the JAX package's bf16
tolerance), and the one-device step's fp32 params to the JAX step's
(rtol 1e-5, atol 1e-6; the key bias apart). MoE on two data ranks routes
in two groups, each with its own capacity, as the JAX step does on a
data mesh: its losses are held to the port's one-device step routing in
two groups and to the JAX step on a 2 x 1 mesh of two host devices (a
subprocess). Planted faults (an update not applied, a step on half the
batch, a column-parallel bias gradient not summed over "model") must
fail the comparison.
"""
import dataclasses
import json
import multiprocessing
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from port import mesh_worker
from repro.configs import reduced_arch as jreduced
from repro.core.optim import adamw as jadamw
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

STEPS = mesh_worker.STEPS
CASES = mesh_worker.CASES
SPLIT_CASES = mesh_worker.SPLIT_CASES
ALL_CASES = mesh_worker.ALL_CASES
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


def _lm_batches(cfg):
    rng = np.random.default_rng(0)
    return [mesh_worker.lm_batch(rng, cfg) for _ in range(STEPS)]


def _jarch(name):
    """The JAX package's reduced arch of a case (mesh_worker.VARIANTS
    applied)."""
    base, over = mesh_worker.VARIANTS.get(name, (name, {}))
    ja = jreduced(base)
    return dataclasses.replace(ja, cfg=dataclasses.replace(ja.cfg, **over))


def _jax_tx(name):
    if name == "fused_lans":
        return jfused_lans(mesh_worker.LR), "fp32"
    if name == "fused_lamb":
        return jfused_lamb(mesh_worker.LR), "fp32"
    if name == "adamw":
        return jadamw(mesh_worker.LR), "fp32"
    # the port's fused_mixed_lans is mixed_precision(lans) fused
    # (test_torch_train.py); the JAX builder wraps lans in it
    return jlans(mesh_worker.LR), ("bf16" if name == "fused_mixed_lans"
                                   else "fp32")


def _jax_run(arch_name, optimizer, microbatches, jparams, batches):
    tx, policy = _jax_tx(optimizer)
    ja = _jarch(arch_name)
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
        mesh_worker.reduced(arch_name).cfg,
        jax.tree.map(lambda a: np.asarray(a, np.float32), params))
    return {"losses": losses,
            "params": dict(tree_items(params))}


# The JAX step on a 2 x 1 mesh of two host devices, in a process of its
# own (the flag must be set before JAX starts): the MoE case's losses at
# the mesh's two routing groups. The port's fused_lans is lans fused.
_JAX_DATA2 = textwrap.dedent("""
    import dataclasses, json, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import reduced_arch
    from repro.core.optim import lans
    from repro.distributed.steps import build_train_step, jit_train_step
    from repro.launch.mesh import make_local_mesh
    from repro.precision import get_policy
    arch_name, lr, path = sys.argv[1], float(sys.argv[2]), sys.argv[3]
    ja = reduced_arch(arch_name)
    ja = dataclasses.replace(ja, cfg=dataclasses.replace(
        ja.cfg, compute_dtype=jnp.float32))
    data = np.load(path)
    steps = sorted({k.split("/")[0] for k in data.files})
    batches = [{k.split("/")[1]: jnp.asarray(data[k]) for k in data.files
                if k.startswith(s + "/")} for s in steps]
    mesh = make_local_mesh(data=2, model=1)
    params0 = ja.init(jax.random.PRNGKey(0))
    step, init, specs_for = build_train_step(
        ja.loss_fn, lans(lr), mesh, param_init_fn=lambda _: params0,
        policy=get_policy("fp32"))
    params, state = init(None)
    pspec, ospec = specs_for(params, state)
    losses = []
    with mesh:
        jitted = jit_train_step(step, mesh, pspec, ospec, batches[0])
        for b in batches:
            params, state, m = jitted(params, state, b)
            losses.append(float(m["loss"]))
    print(json.dumps(losses))
""")


def _jax_data2_losses(tmp, arch_name, batches):
    path = tmp / f"batches-{arch_name}.npz"
    np.savez(path, **{f"{i:02d}/{k}": v for i, b in enumerate(batches)
                      for k, v in b.items()})
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
           "PYTHONPATH": os.pathsep.join(
               [os.path.abspath("src"), os.environ.get("PYTHONPATH", "")])}
    out = subprocess.run(
        [sys.executable, "-c", _JAX_DATA2, arch_name, str(mesh_worker.LR),
         str(path)], env=env, capture_output=True, text=True, timeout=600,
        check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{layout: {case: rank 0's results}, "one": ..., "jax": ...}: every
    layout's pair started first, the references computed while they run,
    then each pair joined."""
    tmp = tmp_path_factory.mktemp("mesh")
    jparams, tparams, np_batches = {}, {}, {}
    for name in dict.fromkeys(a for a, _, _ in ALL_CASES.values()):
        ja = _jarch(name)
        jparams[name] = jax.jit(ja.init)(jax.random.PRNGKey(0))
        tparams[name] = params_from_jax(mesh_worker.reduced(name).cfg,
                                        jax.tree.map(np.asarray,
                                                     jparams[name]))
        np_batches[name] = (_bert_batches(ja.cfg.vocab)
                            if name == "bert-large" else _lm_batches(ja.cfg))
    every = {name: dict(arch=a, optimizer=o, microbatches=mb,
                        batches=[{k: torch.from_numpy(v) for k, v in b.items()}
                                 for b in np_batches[a]])
             for name, (a, o, mb) in ALL_CASES.items()}
    cases = {name: every[name] for name in CASES}
    inputs = {name: tmp / f"inputs-{name}.pt" for name in ("all", "1x2")}
    torch.save({"params": tparams, "cases": cases}, inputs["all"])
    torch.save({"params": tparams, "cases": every}, inputs["1x2"])

    ctx = multiprocessing.get_context("spawn")
    procs = {lname: mesh_worker.start_ranks(
        ctx, layout, tmp, inputs["1x2" if lname == "1x2" else "all"], lname)
        for lname, layout in LAYOUTS.items()}
    out = {"one": {}, "order2": {}, "order2-zero3": {}, "order1x2": {},
           "order2x2": {}, "groups2": {}, "jax": {}, "jax2": {}}
    threads = torch.get_num_threads()
    # one thread, as each rank runs: a CPU sum's order follows the count
    torch.set_num_threads(1)
    try:
        for name, case in cases.items():
            params = tparams[case["arch"]]
            refs = [("one", dict(data=1)), ("order2", dict(data=2))]
            # zero3 sums its data-cut leaves' gradients per microbatch, in
            # their dtype
            refs.append(("order2-zero3", dict(
                data=2, early=mesh_worker.early_paths(params, 2))))
            # the matmuls split over two model ranks, as 1 x 2 and 2 x 2
            refs += [("order1x2", dict(model=2)),
                     ("order2x2", dict(data=2, model=2))]
            if mesh_worker.is_moe(name):
                refs.append(("groups2", dict(data=2, order=False)))
                out["jax2"][name] = _jax_data2_losses(
                    tmp, case["arch"], np_batches[case["arch"]])
            for key, kw in refs:
                losses, got, *_ = mesh_worker.run_steps(
                    case, params, case["batches"], **kw)
                out[key][name] = {"losses": losses, "params": got}
            out["jax"][name] = _jax_run(case["arch"], case["optimizer"],
                                        case["microbatches"],
                                        jparams[case["arch"]],
                                        np_batches[case["arch"]])
        for name in SPLIT_CASES:
            case = every[name]
            for key, kw in (("one", dict(data=1)),
                            ("order1x2", dict(model=2))):
                losses, got, *_ = mesh_worker.run_steps(
                    case, tparams[case["arch"]], case["batches"], **kw)
                out[key][name] = {"losses": losses, "params": got}
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


def _reference(layout):
    """The key of a layout's mesh-order reference."""
    lay = LAYOUTS[layout]
    if lay["model"] > 1:
        return f"order{lay['data']}x{lay['model']}"
    if lay["data"] == 1:
        return "one"
    return "order2-zero3" if lay["zero3"] else "order2"


def _groups2(layout, case):
    """MoE on two data ranks routes in two groups (the JAX step's maths
    on such a mesh), which no one-group reference shares."""
    return mesh_worker.is_moe(case) and LAYOUTS[layout]["data"] > 1


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_step_matches_one_device(runs, layout, case):
    """Against the one-device step whose gradient is summed in the
    layout's order (the two data ranks' blocks added, where the batch is
    cut), at mesh_worker's tolerances, every step; the losses also
    against the plain one-device step's (routing in two groups for MoE
    on two data ranks)."""
    got = runs[layout][case]
    want = runs[_reference(layout)][case]
    assert len(got["checks"]) == STEPS
    mesh_worker.check_against_one_device(got, want, LAYOUTS[layout], case)
    plain = runs["groups2" if _groups2(layout, case) else "one"][case]
    np.testing.assert_allclose(got["losses"], plain["losses"],
                               rtol=1e-3 if _bf16(case) else 1e-5)


# held to JAX by their losses only (test_mesh_step_losses_match_jax):
# after the three steps one or two elements of each, whose gradients are
# near rounding noise, stand 1.4e-6 to 4.4e-6 from the JAX step's (adamw:
# two of the key kernel, whose per-element normalization gives such
# elements full-size steps; one KV head: one of the query bias)
NOT_PARAMS_VS_JAX = ("bert-adamw", "qwen_kv1-fused_lans")


@pytest.mark.parametrize("case", [c for c in CASES if not _bf16(c)
                                  and c not in NOT_PARAMS_VS_JAX])
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
                                   "half-batch", "step-key-bias-1x2",
                                   "col-bias-unsummed-1x2"])
def test_mesh_check_catches_planted_faults(runs, fault):
    """The comparison above fails on a run with a planted fault, its
    losses kept so that only the params can show it. On 2 x 1: the
    update never applied (the initial params), the key bias's update
    alone not applied, or each step taken on half the batch (rank 0's
    block alone, as a rank whose gradient was never added to the
    other's). On 1 x 2, whose key bias is held step by step: the key
    bias not updated on any step; or the gradient of a column-parallel
    bias (the query's) left as rank 0's part, not assembled over
    "model" (the other rank's half of it 0)."""
    case = "bert-fused_lans"
    init = runs["init"]["bert-large"]
    layout = "1x2" if fault.endswith("-1x2") else "2x1"
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
    elif fault == "step-key-bias-1x2":
        got = {**got, "checks": [
            {**c, "params": {p: init[p] if mesh_worker.key_bias(p) else v
                             for p, v in c["params"].items()}}
            for c in got["checks"]]}
    else:
        bias = "layers/attn/wq/bias"

        def unsummed(g):
            g = g.clone()
            g[..., g.shape[-1] // 2:] = 0
            return g

        got = {**got, "checks": [
            {**c, "grads": {**c["grads"], bias: unsummed(c["grads"][bias])}}
            for c in got["checks"]]}
    want = runs[_reference(layout)][case]
    with pytest.raises(AssertionError):
        mesh_worker.check_against_one_device(got, want, LAYOUTS[layout],
                                             case)


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_case_matches_one_device_on_1x2(runs, case):
    """The model axis's splits of the experts, the vocab and the Mamba-2
    mixers (SPLIT_CASES, 1 x 2 only): against the one-device step that
    splits them as the two ranks do (mesh_worker.model_split), every
    step's params, gradient and update on the mesh's own gradient and
    the params after the steps (check_against_one_device); the losses
    also against the plain one-device step's (1e-5); K1-K3's sums of
    squares added in one all-reduce for each of the step's two
    reductions."""
    got = runs["1x2"][case]
    assert len(got["checks"]) == STEPS
    mesh_worker.check_against_one_device(got, runs["order1x2"][case],
                                         LAYOUTS["1x2"], case)
    np.testing.assert_allclose(got["losses"], runs["one"][case]["losses"],
                               rtol=1e-5)
    assert got["calls"] == [2] * STEPS


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_step_losses_match_jax(runs, layout, case):
    """Against the JAX step on a 1 x 1 mesh; MoE on two data ranks
    against the JAX step on a 2 x 1 mesh (two routing groups)."""
    want = (runs["jax2"][case] if _groups2(layout, case)
            else runs["jax"][case]["losses"])
    np.testing.assert_allclose(runs[layout][case]["losses"], want,
                               rtol=3e-2 if _bf16(case) else 1e-5)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_partial_allreduces_per_step(runs, layout):
    """The fused optimizers add their sums of squares over the ranks only
    for leaves cut over them: none on 2 x 1 (every leaf whole), and on the
    other layouts one stacked all-reduce per group of cut leaves (here one
    group: model on 1 x 2 and 2 x 2, data under zero3 and ZeRO-1) for
    each of the two reductions of a step (K1's g_sq and K2's norms; K1's
    sums for LAMB's clip and K5's norms). The unfused lans and adamw
    reduce through DTensor's own ops and issue none of these."""
    want = 0 if layout == "2x1" else 2
    for case, (_, optimizer, _) in CASES.items():
        calls = runs[layout][case]["calls"]
        unfused = optimizer in ("lans", "adamw")
        assert calls == [0 if unfused else want] * STEPS, case
