"""The harness finds every cell's files by name, refuses bad names, and
refuses to run without a card; a run with a fault planted in the timed
path comes out not correct."""
import json
import sys
import time

import pytest
import torch

from bench.tests._tiny import ROOT, tiny_job
from bench.harness import check, spec, train

BENCH = spec.load()
CELLS = [c.name for c in spec.cells(BENCH)]


def test_benchmark_json_has_the_contract_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench/run.py"]
    assert BENCH["paths"] == ["bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files(name):
    cell = spec.cell(name, BENCH)
    conf = cell.load_config()
    job = train.job_of(cell)
    assert job.mix.data == cell.chips
    assert spec.kind_module("reference", conf["reference"])
    assert spec.kind_module("cost", conf["cost"])
    lim = check.limits(name)
    assert lim and set(lim) <= {"loss1", "loss", "grad", "grad_dir",
                                "change", "grad0", "watch"}
    assert all(v > 0 for v in lim.values())
    e2e = {m.name for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        mod = spec.metric_module(m.name)
        assert (mod.UNIT, mod.MOVES, mod.LAYER, mod.SOURCE) == (
            m.unit, m.moves, m.layer, m.source)
        assert m.moves in e2e


def test_every_configuration_is_used_and_its_file_named():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert (ROOT / c["file"]).exists()
        assert c["file"] == f"bench/configs/{c['name']}.json"
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["source"] == c["source"]
        for key in c["reduced"]:
            assert key in conf["published"]


@pytest.mark.parametrize("bad", ["a b", "a/b", ".a", "-a", "", "x" * 65,
                                 "café", "a,b"])
def test_bad_names_are_refused(bad):
    with pytest.raises(ValueError):
        spec.check_name(bad)


@pytest.mark.parametrize("bad", ["tokens per s", "µs", "", "x" * 17,
                                 "a\tb"])
def test_bad_units_are_refused(bad):
    with pytest.raises(ValueError):
        spec.check_unit(bad)


@pytest.mark.parametrize("good", ["tokens/s", "%", "GiB", "ms", "s"])
def test_good_units_pass(good):
    assert spec.check_unit(good) == good


def test_run_refuses_without_a_card(monkeypatch, capsys):
    from bench import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code = run.main(["--workload", CELLS[0], "--seed", "2147483659",
                     "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert code != 0 and out.out == ""
    assert "CUDA" in out.err


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    from bench import run
    for name in [m for m in sys.modules if m.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch.models", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.models", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax", "repro"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "ffn_fp8"])
def test_a_planted_fault_comes_out_not_correct(fault):
    torch.manual_seed(0)
    job = tiny_job("bert-large.p1-seq128")
    res = train.run(job, 2 ** 31 + 11, 0.2, False,
                    device=torch.device("cpu"),
                    t_start=time.perf_counter(), fault=fault)
    assert res["correct"] is False
    assert list(res)[-1] == "check"
    assert set(res["check"]) >= {"loss1", "loss", "grad", "grad_dir",
                                 "change"}


def test_the_ffn_fault_is_undone_when_the_run_is_freed():
    from repro_torch.models import bert
    plain = bert.mlp_apply
    job = tiny_job("bert-large.p1-seq128")
    run = train.Run(job, 2 ** 31 + 13, torch.device("cpu"), "ffn_fp8")
    assert bert.mlp_apply is not plain
    run.free()
    assert bert.mlp_apply is plain


def test_an_unknown_fault_is_refused():
    job = tiny_job("bert-large.p1-seq128")
    with pytest.raises(ValueError):
        train.Run(job, 1, torch.device("cpu"), "no_exchange")
