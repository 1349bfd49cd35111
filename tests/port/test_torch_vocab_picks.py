"""The serving picks on vocab-parallel logits (serving/sampler.py:
VocabCut), on 2 and 4 gloo ranks, against `Sampler.sample` on the whole
row, bit for bit.

Each rank holds its columns of the same (9, 96) fp32 rows, made from a
seed with numpy, and picks with greedy, the tie-stable greedy,
temperature, top_k (below and above a rank's width), top_p and the
serve CLI's temperature / top_k / top_p mix, with JAX's per-row keys
(tests/port/serve_worker.py: run_pick_rank). The rows:

  0-3  normal draws (scale 3);
  4    a tie across a rank boundary: the max at the last column of rank 0,
       the first of rank 1 and the first of rank 2 (greedy and stable:
       the lower index);
  5    a stable band that spans two ranks: the max on rank 1, a value one
       bf16 ulp below it on rank 0 (stable: rank 0's index; greedy:
       rank 1's);
  6    two NaNs and an inf in rank 1's columns of 2 (rank 2's of 4;
       greedy: the first NaN, as torch.argmax; the non-finite flag raised
       on every rank, though no other rank holds one);
  7    a constant row (index 0);
  8    -1e30 but for one column of the last rank.

Also: greedy and stable never gather more than a pair of values per row
(never the row), and a planted pick that ignores the rank's offset
fails the comparison.
"""
import multiprocessing

import numpy as np
import pytest
import torch

from port import serve_worker as sw
from repro_torch.serving.sampler import (Sampler, fold_keys, greedy,
                                         nonfinite, prng_key)

V = 96
ROWS = 9
WORLDS = (2, 4)
SAMPLERS = ["greedy", "temperature=0,stable=1", "temperature=0.8,seed=3",
            "temperature=0.8,top_k=20,seed=3",
            "temperature=0.8,top_k=30,seed=3",
            "temperature=0.8,top_p=0.9,seed=3",
            "temperature=0.8,top_k=50,top_p=0.9,seed=3"]
JOIN_S = 120


def _rows():
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((ROWS, V)) * 3).astype(np.float32)
    x[4] = rng.uniform(0, 5, V).astype(np.float32)
    for c in (23, 24, 48):         # rank boundaries of 4 and 2 ranks
        x[4, c] = 9.0
    x[5] = rng.uniform(0, 5, V).astype(np.float32)
    x[5, 60] = 8.0                 # rank 1 of 2, rank 2 of 4
    x[5, 5] = 8.0 - 0.01           # inside the band 2**-7 * 8
    x[6, 50] = np.nan              # rank 1 of 2, rank 2 of 4
    x[6, 70] = np.nan
    x[6, 60] = np.inf
    x[7] = 0.5
    x[8] = -1e30
    x[8, V - 3] = 1.0
    return torch.from_numpy(x)


def _keys():
    base = np.stack([Sampler(seed=3).request_key(r) for r in range(ROWS)])
    return fold_keys(base, np.arange(ROWS) + 4)


@pytest.fixture(scope="module")
def picks(tmp_path_factory):
    """{world: [rank's record]}, and the inputs."""
    tmp = tmp_path_factory.mktemp("picks")
    inputs = {"logits": _rows(), "keys": _keys(), "samplers": SAMPLERS}
    torch.save(inputs, tmp / "inputs.pt")
    ctx = multiprocessing.get_context("spawn")
    procs = {w: sw.start(ctx, sw.run_pick_rank, w, tmp, f"w{w}",
                         str(tmp / "inputs.pt")) for w in WORLDS}
    return {w: sw.join(ps, tmp, f"w{w}", JOIN_S)
            for w, ps in procs.items()}, inputs


@pytest.mark.parametrize("spec", SAMPLERS)
@pytest.mark.parametrize("world", WORLDS)
def test_picks_equal_the_whole_row(picks, world, spec):
    ranks, inputs = picks
    want = Sampler.parse(spec).sample(inputs["logits"], inputs["keys"])
    for rank in ranks[world]:
        got = rank["picks"][spec]
        assert got.dtype == torch.int32
        assert torch.equal(got, want), (spec, got, want)


@pytest.mark.parametrize("world", WORLDS)
def test_ties_go_to_the_lower_index(picks, world):
    """Row 4's max sits at the last column of rank 0 and the first of
    rank 1; row 5's band spans two ranks."""
    ranks, _ = picks
    for rank in ranks[world]:
        assert int(rank["picks"]["greedy"][4]) == 23
        assert int(rank["picks"]["temperature=0,stable=1"][4]) == 23
        assert int(rank["picks"]["greedy"][5]) == 60
        assert int(rank["picks"]["temperature=0,stable=1"][5]) == 5


@pytest.mark.parametrize("world", WORLDS)
def test_nonfinite_flag_on_every_rank(picks, world):
    """Only rank 1 of 2 (rank 2 of 4) holds row 6's NaNs and inf, yet
    every rank raises the flag; greedy picks the first NaN, as
    torch.argmax does."""
    ranks, inputs = picks
    assert [r["flag"] for r in ranks[world]] == [1] * world
    own = [r["own_flag"] for r in ranks[world]]
    assert own == ([0, 1] if world == 2 else [0, 0, 1, 0])
    for rank in ranks[world]:
        assert int(rank["picks"]["greedy"][6]) == 50
    assert int(nonfinite(inputs["logits"])) == 1


@pytest.mark.parametrize("world", WORLDS)
def test_greedy_and_stable_never_gather_the_row(picks, world):
    """The widest tensor a greedy or stable pick gathers holds a value
    and an index per row, never a row; top_p gathers the rows."""
    ranks, _ = picks
    for rank in ranks[world]:
        assert rank["widest"]["greedy"] <= 2 * ROWS
        assert rank["widest"]["temperature=0,stable=1"] <= ROWS
        assert rank["widest"]["temperature=0.8,seed=3"] <= 2 * ROWS
        assert rank["widest"]["temperature=0.8,top_p=0.9,seed=3"] == \
            ROWS * V // world


@pytest.mark.parametrize("world", WORLDS)
def test_planted_offset_fault_fails_the_comparison(picks, world):
    """A pick that takes every rank's columns as the row's first ones
    (VocabCut.offset 0) parts from the whole row's argmax."""
    ranks, inputs = picks
    want = greedy(inputs["logits"])
    assert not torch.equal(ranks[world][0]["fault"], want)


def test_one_device_picks_are_unchanged():
    """Without a cut every pick is the whole-row code: greedy is
    torch.argmax, and the stream key is JAX's."""
    x = _rows()
    assert torch.equal(greedy(x), torch.argmax(x, -1).to(torch.int32))
    assert prng_key(3).tolist() == [0, 3]
