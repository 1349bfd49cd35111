"""The mesh train step cuts memory and compute per rank (distributed/
steps.py), held under gloo on the CPU, one set of spawned ranks per
layout (tests/port/mesh_worker.py: run_cut_rank), for reduced
bert-large, qwen2.5-14b (untied lm_head), jamba-1.5-large-398b (MoE and
Mamba-2) and gemma2-2b (tied, soft-capped readout) with fused_lans:

- the fetch gathers one layer's leaf, or one leaf that is not stacked,
  at a time, never a stacked leaf whole (2 x 1 with zero3, 1 x 2, 2 x
  2; every gathered shape is recorded by wrapping partial.gather_leaf);
  with a model axis (1 x 2, 2 x 2) it gathers no MoE expert stack, no
  vocab-cut embedding or lm_head and no Mamba-2 in_proj, conv_w or
  out_proj at any shape: the ranks compute on their shards;
- on 1 x 2 the matmul FLOPs (forward, recompute and backward, counted
  on each rank by torch.utils.flop_counter.FlopCounterMode) that each
  of mesh_worker.FLOP_DELTAS adds to a step are exactly half of what it
  adds to the one-device step: a layer (attention and MLP split over
  "model"), the readout, the MoE experts (dense route) and the Mamba-2
  mixers' heads;
- a step on a mesh is not built without the attention's heads, which
  its split needs.
"""
import multiprocessing

import pytest
import torch

from port import mesh_worker
from repro_torch.core.optim.base import tree_items

LAYOUTS = {
    "2x1-zero3": dict(data=2, model=1, zero3=True, zero1=False),
    "1x2": dict(data=1, model=2, zero3=False, zero1=False, flops=True),
    "2x2": dict(data=2, model=2, zero3=False, zero1=False),
}
JOIN_S = 300


@pytest.fixture(scope="module")
def cut_runs(tmp_path_factory):
    """{layout: [each rank's results]}, every layout's ranks started at
    once."""
    tmp = tmp_path_factory.mktemp("cut")
    ctx = multiprocessing.get_context("spawn")
    procs = {}
    for name, layout in LAYOUTS.items():
        world = layout["data"] * layout["model"]
        procs[name] = [ctx.Process(target=mesh_worker.run_cut_rank, args=(
            r, world, str(tmp / f"store-{name}"), layout,
            str(tmp / f"out-{name}"))) for r in range(world)]
        for p in procs[name]:
            p.start()
    out = {}
    try:
        for name, ranks in procs.items():
            for p in ranks:
                p.join(JOIN_S)
            codes = [p.exitcode for p in ranks]
            assert codes == [0] * len(ranks), f"{name}: exit codes {codes}"
            out[name] = [torch.load(tmp / f"out-{name}.{r}")
                         for r in range(len(ranks))]
    finally:
        for ranks in procs.values():
            for p in ranks:
                if p.is_alive():
                    p.kill()
                    p.join()
    return out


def _leaf_shapes(arch_name):
    """(shapes of one layer of each stacked leaf and of each leaf that is
    not stacked, shapes of the stacked leaves whole that the rules may
    cut: those of two dims or more a layer; a layer's 1-D leaves are
    never cut)."""
    arch = mesh_worker.case_arch(arch_name, "fp32")
    with torch.device("meta"):
        params = arch.init(None)
    stacked = ("layers", "slot")
    allowed, whole = set(), set()
    for path, v in tree_items(params):
        if path.startswith(stacked):
            allowed.add(tuple(v.shape[1:]))
            if v.ndim >= 3:
                whole.add(tuple(v.shape))
        else:
            allowed.add(tuple(v.shape))
    return allowed, whole


@pytest.mark.parametrize("arch", mesh_worker.CUT_ARCHS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_fetch_gathers_one_layer_at_a_time(cut_runs, layout, arch):
    allowed, whole = _leaf_shapes(arch)
    cut, other = mesh_worker.model_cut_shapes(
        mesh_worker.case_arch(arch, "fp32"))
    # a shape shared with a leaf that may be gathered would hide one
    assert not cut & other, cut & other
    for rank in cut_runs[layout]:
        gathered = rank[arch]["gathered"]
        if LAYOUTS[layout]["zero3"]:
            # every leaf of two dims or more is cut over "data"
            assert gathered, "nothing was gathered"
        assert not set(gathered) & whole, gathered
        assert set(gathered) <= allowed, set(gathered) - allowed
        if LAYOUTS[layout]["model"] > 1:
            assert not set(gathered) & cut, set(gathered) & cut
        if gathered:
            biggest = max(gathered, key=lambda s: torch.Size(s).numel())
            assert torch.Size(biggest).numel() <= max(
                torch.Size(s).numel() for s in allowed)


@pytest.mark.parametrize("arch", mesh_worker.CUT_ARCHS)
def test_layer_flops_halve_on_1x2(cut_runs, arch):
    ranks = cut_runs["1x2"]
    one = {k: v[1] for k, v in ranks[0][arch]["flops"].items()}  # rank 0's
    for rank in ranks:
        mesh = {k: v[0] for k, v in rank[arch]["flops"].items()}
        for delta in mesh_worker.FLOP_DELTAS[arch]:
            d_one = one[delta] - one["base"]
            d_mesh = mesh[delta] - mesh["base"]
            assert d_one != 0, delta
            assert 2 * abs(d_mesh) == abs(d_one), (delta, d_mesh, d_one)


def test_mesh_step_needs_heads():
    """On a mesh the step needs the attention's (n_heads, n_kv) to plan
    the split: without them it raises, rather than gather attention on
    every rank and cut less than its callers expect."""
    from repro_torch.core.optim import fused_lans
    from repro_torch.distributed.steps import build_train_step
    arch = mesh_worker.case_arch("bert-large", "fp32")
    with pytest.raises(ValueError, match="heads"):
        build_train_step(arch.loss_fn, fused_lans(mesh_worker.LR),
                         mesh=object())
