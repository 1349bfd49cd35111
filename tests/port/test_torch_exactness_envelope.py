"""The exactness envelope of serving on a mesh, for every family (the
port of tests/test_exactness_envelope.py, on its workloads): decoder
generation (reduced qwen2.5-14b), BERT scoring (reduced bert-large, task
"score": MLM ids and pooled embeddings) and the encoder-decoder (reduced
whisper-large-v3), each through the port's ContinuousEngine on a mesh of
gloo ranks (tests/port/serve_worker.py), against the port's one-device
engine on the same requests.

  * A data mesh (2 x 1) cuts the slots, the pools and each scoring batch
    over its ranks and prefills every admitted group whole on each:
    every output is array-equal to one device's under every policy
    (None, fp32, bf16, fp16_mixed): tokens, MLM ids and embeddings.
  * A model mesh (1 x 2) splits the attention (on whole heads) and MLP
    matmuls and sums their parts in rank order: fp32 keeps every argmax
    on its side of its boundary, so tokens and MLM ids are equal, and
    the embeddings are held at JAX's tolerances (rtol 1e-4, atol 1e-6).

Each layout runs once, in one set of spawned processes, for all of its
cases; the one-device references run here meanwhile with one CPU thread,
as each rank.

A one-row product takes BLAS's matrix-vector path, whose fp32 sums run
in another order than a many-row product's: that is why a rank whose
block is one slot runs two rows, the second dead
(distributed/sharding.py: ServeLayout).
test_one_row_product_parts_from_many_rows shows the parting, and two
scoring slots on 2 x 1 (a pooler product of one row per rank without
the pad) stay bit-exact.
"""
import multiprocessing

import jax
import numpy as np
import pytest
import torch

from port import serve_worker as sw
from repro.configs import reduced_arch as jreduced
from repro_torch.bridge import params_from_jax
from repro_torch.configs import reduced_arch

FAMILIES = ("decoder", "scoring", "encdec")
POLICIES = [str(p) for p in sw.POLICIES]
LAYOUT_CASES = {
    "2x1": [f"env-{f}-{p}" for f in FAMILIES for p in POLICIES]
    + ["scoring-block1"],
    "1x2": [f"env-{f}-fp32" for f in FAMILIES],
}
JOIN_S = 300


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{layout: [rank results]}, "one": {case: one-device result}."""
    tmp = tmp_path_factory.mktemp("envelope")
    params = {}
    for name in sw.ARCHS:
        jparams = jreduced(name).init(jax.random.PRNGKey(0))
        params[name] = params_from_jax(reduced_arch(name).cfg,
                                       jax.tree.map(np.asarray, jparams))
    inputs = tmp / "params.pt"
    torch.save(params, inputs)
    ctx = multiprocessing.get_context("spawn")
    procs = {lay: sw.start(ctx, sw.run_rank,
                           sw.LAYOUTS[lay]["data"] * sw.LAYOUTS[lay]["model"],
                           tmp, lay, sw.LAYOUTS[lay], names, str(inputs))
             for lay, names in LAYOUT_CASES.items()}
    out = {"one": {}}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for name in LAYOUT_CASES["2x1"]:
            out["one"][name] = sw.run_case(name, params)
    finally:
        torch.set_num_threads(threads)
        for lay, ranks in procs.items():
            out[lay] = sw.join(ranks, tmp, lay, JOIN_S)
    return out


def _outputs(result):
    return result["tokens"], [e for e in result["embeddings"]
                              if e is not None]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("policy", POLICIES)
def test_data_mesh_bit_exact_under_every_policy(runs, family, policy):
    name = f"env-{family}-{policy}"
    base_tok, base_f = _outputs(runs["one"][name])
    for rank in runs["2x1"]:
        got_tok, got_f = _outputs(rank[name])
        assert len(got_tok) == len(base_tok) and len(got_f) == len(base_f)
        for x, y in zip(base_tok + base_f, got_tok + got_f):
            np.testing.assert_array_equal(x, y)
    if family == "scoring":
        assert len(base_f) == 5


@pytest.mark.parametrize("family", FAMILIES)
def test_model_mesh_fp32_cross_layout_identity(runs, family):
    name = f"env-{family}-fp32"
    base_tok, base_f = _outputs(runs["one"][name])
    for rank in runs["1x2"]:
        got_tok, got_f = _outputs(rank[name])
        assert len(got_tok) == len(base_tok) and len(got_f) == len(base_f)
        for x, y in zip(base_tok, got_tok):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(base_f, got_f):
            np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("layout", sorted(LAYOUT_CASES))
def test_ranks_agree(runs, layout):
    for name in LAYOUT_CASES[layout]:
        assert sw.ranks_agree(runs[layout], name), name


def test_one_slot_block_is_bit_exact(runs):
    """Two scoring slots on 2 x 1: each rank's block is one slot, whose
    pooler product would be one row; the dead pad row keeps the
    embeddings one device's bits."""
    base_tok, base_f = _outputs(runs["one"]["scoring-block1"])
    got_tok, got_f = _outputs(runs["2x1"][0]["scoring-block1"])
    for x, y in zip(base_tok + base_f, got_tok + got_f):
        np.testing.assert_array_equal(x, y)


def test_one_row_product_parts_from_many_rows():
    """The finding behind the dead pad row: on this BLAS an fp32 product
    of one row is not bit for bit the first row of the same product over
    two rows, while two rows are the first two of four. A one-slot data
    block decoding alone would part from one device in its last bits."""
    torch.manual_seed(0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        w = torch.randn(256, 1024)
        x = torch.randn(4, 1, 256)
        four = torch.matmul(x, w)
        assert torch.equal(torch.matmul(x[:2], w), four[:2])
        assert not torch.equal(torch.matmul(x[:1], w), four[:1])
    finally:
        torch.set_num_threads(threads)
