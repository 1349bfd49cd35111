"""The dry run's analysis (repro_torch/launch/trace_analysis.py) against the
JAX package's hlo_analysis on the same inputs, the card's constants
(launch/mesh.py), and the bounds chip_smoke.py prints, which now read
the cost functions beside the kernels and those constants: each is
pinned at the value the script printed before it read them.

For the roofline, the JAX module's TPU constants are set to the card's
inside the test (monkeypatch on repro.launch.mesh; nothing in src/repro
changes), so that both sides compute the same terms.
"""
import os
import subprocess
import sys

import pytest
import torch

from repro.launch import hlo_analysis as jha
from repro.launch import mesh as jmesh
from repro_torch.kernels import lamb as kb
from repro_torch.kernels import lans as kl
from repro_torch.kernels import paged_attention as pa
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import trace_analysis as ta

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the repo root's script, stdlib at import)

LARGEST_LEAF = 24 * 1024 * 4096     # BERT-large's layers/mlp/up/kernel


def test_card_constants():
    assert tmesh.PEAK_FLOPS == {"bfloat16": 989e12, "float16": 989e12,
                                "tf32": 495e12, "float32": 67e12,
                                "elementwise": 67e12}
    assert (tmesh.HBM_BW, tmesh.HBM_BYTES, tmesh.NVLINK_BW) == (
        3.35e12, 80e9, 450e9)


def test_no_tpu_constant_in_the_port():
    src = os.path.join(ROOT, "src", "repro_torch")
    out = subprocess.run(["grep", "-rn", r"197e12\|819e9\|50e9\|v5e", src],
                         capture_output=True, text=True)
    assert out.stdout == "", out.stdout


@pytest.mark.parametrize("flops,nbytes,coll,n", [
    (1e15, 1e12, 1e10, 1), (3.3e17, 2e13, 5e12, 256),
    (1e12, 9e13, 0.0, 512), (0.0, 0.0, 7e11, 16)])
def test_roofline_terms_equal_jax(monkeypatch, flops, nbytes, coll, n):
    monkeypatch.setattr(jmesh, "PEAK_FLOPS_BF16", tmesh.PEAK_FLOPS["bfloat16"])
    monkeypatch.setattr(jmesh, "HBM_BW", tmesh.HBM_BW)
    monkeypatch.setattr(jmesh, "ICI_BW", tmesh.NVLINK_BW)
    assert ta.roofline_terms(flops, nbytes, coll, n) == jha.roofline_terms(
        flops, nbytes, coll, n)


def test_roofline_charges_each_dtype_at_its_peak():
    t = ta.roofline_terms({"bfloat16": 989e12, "float32": 67e12,
                           "elementwise": 67e12}, 3.35e12, 0.0, 1)
    assert t["compute_s"] == pytest.approx(3.0)
    assert t["memory_s"] == pytest.approx(1.0)
    assert (t["dominant"], t["bound_s"]) == ("compute_s", t["compute_s"])
    fp32 = ta.roofline_terms({"float32": 1e15}, 0.0, 0.0, 1)["compute_s"]
    bf16 = ta.roofline_terms({"bfloat16": 1e15}, 0.0, 0.0, 1)["compute_s"]
    assert fp32 / bf16 == pytest.approx(989 / 67)


@pytest.mark.parametrize("n,d", [(336201532, 4096), (1, 1), (2 ** 33, 7)])
def test_model_flops_equal_jax(n, d):
    assert ta.model_flops_training(n, d) == jha.model_flops_training(n, d)
    assert ta.model_flops_inference(n, d) == jha.model_flops_inference(n, d)


HLO = """
%s1 = f32[8,4]{1,0} scatter(%a, %i, %u), update_window_dims={1}
%rs = f32[4]{0} reduce-scatter(%x), replica_groups={}
%s2 = "stablehlo.scatter"(%a, %i, %u)
%ag = f32[16]{0} all-gather(%y), dimensions={0}
%g = f32[2,4]{1,0} gather(%a, %i), offset_dims={1}
%rs2 = "stablehlo.reduce_scatter"(%x)
%c = f32[2]{0} add(%p, %q)
"""


@pytest.mark.parametrize("kinds", [("scatter",), ("gather", "scatter"),
                                   ("add", "all-gather", "reduce-scatter")])
def test_op_counts_equal_jax_on_the_same_text(kinds):
    assert ta.op_counts(HLO, kinds) == jha.op_counts(HLO, kinds)


def test_op_counts_on_aten_names():
    names = ["aten.scatter.src", "aten.scatter_add.default",
             "c10d._reduce_scatter_base_.default",
             "_c10d_functional.reduce_scatter_tensor.default",
             "aten.gather.default", "c10d._allgather_base_.default",
             "aten.index_put_.default", "aten.scatter.value"]
    assert ta.op_counts(names, ("scatter", "gather", "index_put_",
                                "scatter_add")) == {
        "scatter": 2, "gather": 1, "index_put_": 1, "scatter_add": 1}


# chip_smoke.py's bounds, as it printed them before it read the kernels'
# cost functions and launch/mesh.py: bytes at 3.35e12 B/s and FLOPs at
# 67e12 FLOP/s, the larger one
def _old_bound(nbytes, flops):
    t_bytes, t_ops = nbytes / 3.35e12 * 1e3, flops / 67e12 * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


OLD_PER_ELEMENT = {   # name: (bytes, flops) per fp32 element
    "sq_norm": (4, 2), "lans_phase1": (24, 24), "lans_phase2": (20, 16),
    "lans_phase2_cast": (22, 16), "lamb_phase1": (24, 20),
    "lamb_phase2": (16, 10)}


@pytest.mark.parametrize("n", [LARGEST_LEAF, 256000 * 2304, 32 * 5120 * 1280,
                               LARGEST_LEAF // 4])
@pytest.mark.parametrize("name", list(OLD_PER_ELEMENT))
def test_optimizer_kernel_bounds_unchanged(name, n):
    t = torch.empty(n, device="meta")
    flops, nbytes = chip_smoke.kernel_cost(name, t, t)
    b, f = OLD_PER_ELEMENT[name]
    assert (nbytes, flops) == (b * n, f * n)
    assert chip_smoke.card_bound(flops, nbytes) == _old_bound(b * n, f * n)


def test_k1_bound_at_the_largest_leaf_is_pinned():
    t = torch.empty(100663296, device="meta")
    ms, by = chip_smoke.card_bound(*kl.sq_norm_cost(t))
    assert (f"{ms:.4f}", by) == ("0.1202", "bytes")


def test_paged_bounds_at_the_serving_shapes_are_pinned():
    args = pa.decode_case(B=4, S=1, n_heads=8, n_kv=4, head_dim=256,
                          block_size=16, nb=6, dtype=torch.bfloat16,
                          q_dtype=torch.float32, seed=99)
    ms, by, nbytes, flops = chip_smoke.paged_bound(args)
    assert (f"{ms:.6f}", by, nbytes, flops) == ("0.000322", "bytes",
                                                1078348, 1998848)
    read = chip_smoke.read_args(args)
    ms7, by7, nbytes7, flops7 = chip_smoke.paged_bound(read)
    # K7 reads the same blocks and writes no rows
    assert (by7, nbytes7, flops7) == ("bytes", 1078348 - 2 * 4 * 4 * 256 * 2
                                      - 4 * 4 - 3 * (2 * 4 * 256 * 2 + 4),
                                      1998848 - 4 * 8 * 256 * 4)
    assert ms7 == pytest.approx(nbytes7 / 3.35e12 * 1e3)


def test_whole_update_bounds_unchanged():
    from repro_torch.configs import get_arch
    from repro_torch.core.optim.base import tree_leaves
    leaves = tree_leaves(get_arch("bert-large").abstract_params())
    n = sum(t.numel() for t in leaves)
    assert chip_smoke.update_bytes(leaves, chip_smoke.LANS_K123) == 48 * n
    assert chip_smoke.update_bytes(
        leaves, ("lamb_phase1", "lamb_phase2")) == 40 * n
    assert chip_smoke.update_bytes(leaves, ("sq_norm",)) == 4 * n
    assert chip_smoke.bytes_ms(48 * n) == 48 * n / 3.35e12 * 1e3
