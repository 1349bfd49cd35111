"""The harness finds every cell's files by name, refuses bad names, and
refuses to run without a card; a run with a fault planted in the timed
path comes out not correct."""
import dataclasses
import json
import sys
import time
import types

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
    assert spec.kind_module("port", conf["reference"])
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


# each committed configuration's port config, its sizes written out
PORT_SIZES = {
    "bert-large": dict(d_model=1024, n_layers=24, n_heads=16, d_ff=4096,
                       vocab=30522, max_pos=512, type_vocab=2),
    "granite-moe-3b-a800m-16l": dict(
        d_model=1536, n_layers=16, n_heads=24, n_kv_heads=8, head_dim=64,
        d_ff=512, vocab=49155, n_experts=40, top_k=8, capacity_factor=1.25,
        rope_theta=10000, tie_embeddings=True),
}


def _conf(name):
    return json.loads((ROOT / "bench" / "configs" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("name", sorted(PORT_SIZES))
def test_arch_of_gives_the_registered_arch_with_the_files_sizes(name):
    from repro_torch.configs import get_arch
    from bench.harness.program import arch_of
    conf = _conf(name)
    arch = get_arch(conf["port_arch"])
    want = dataclasses.replace(arch, cfg=dataclasses.replace(
        arch.cfg, compute_dtype=torch.bfloat16, param_dtype=torch.bfloat16,
        **PORT_SIZES[name]))
    got = arch_of(conf)
    assert got == want
    assert dataclasses.asdict(got.cfg) == dataclasses.asdict(want.cfg)


@pytest.mark.parametrize("key, value", [("embedding_multiplier", 12.0),
                                        ("rms_norm_eps", 1e-5)])
def test_arch_of_refuses_what_the_port_does_not_run(key, value):
    from bench.harness.program import arch_of
    conf = {**_conf("granite-moe-3b-a800m-16l"), key: value}
    with pytest.raises(ValueError, match=f"{key} = {value}: the port runs"):
        arch_of(conf)


def test_arch_of_names_a_missing_port_module():
    from bench.harness.program import arch_of
    conf = {**_conf("granite-moe-3b-a800m-16l"), "reference": "hybrid_moe"}
    with pytest.raises(ValueError, match="bench/port/hybrid_moe.py"):
        arch_of(conf)


# a hybrid's configuration file as a later cell would bring it: one
# period of jamba-1.5-large-398b (attention, then seven Mamba-2 mixers;
# MoE on every other slot) at sizes of its own
HYBRID = {
    "port_arch": "jamba-1.5-large-398b", "reference": "hybrid_test",
    "hidden_size": 1024, "num_hidden_layers": 8, "num_attention_heads": 8,
    "num_key_value_heads": 2, "intermediate_size": 2048,
    "num_local_experts": 4, "num_experts_per_tok": 2, "vocab_size": 4096,
    "mamba_d_state": 64, "mamba_n_heads": 32, "mamba_d_head": 64,
    "mamba_chunk_size": 128, "hidden_act": "silu",
    "precision": {"compute_dtype": "bfloat16", "param_dtype": "bfloat16"},
}


def _hybrid_port():
    """The port module such a file would bring as bench/port/<kind>.py."""
    port = types.ModuleType("bench.port.hybrid_test")
    keys = {"hidden_size": "d_model", "num_hidden_layers": "n_layers",
            "num_attention_heads": "n_heads",
            "num_key_value_heads": "n_kv_heads",
            "intermediate_size": "d_ff", "vocab_size": "vocab",
            "num_local_experts": "n_experts", "num_experts_per_tok": "top_k",
            "mamba_d_state": "mamba_dstate", "mamba_d_head": "mamba_headdim",
            "mamba_chunk_size": "mamba_chunk"}

    def fields(conf):
        kw = {f: conf[k] for k, f in keys.items()}
        kw["mamba_d_inner"] = conf["mamba_n_heads"] * conf["mamba_d_head"]
        kw["head_dim"] = conf["hidden_size"] // conf["num_attention_heads"]
        return kw

    def check(conf, cfg):
        if not any(m == "mamba" for m, _ in cfg.superblock) \
                or cfg.activation != conf["hidden_act"]:
            raise ValueError("not the hybrid the configuration states")
    port.fields, port.check = fields, check
    return port


def test_a_hybrid_reaches_the_port_through_a_port_module_of_its_own(
        monkeypatch):
    from bench.harness.program import arch_of
    port, plain = _hybrid_port(), spec.kind_module
    monkeypatch.setattr(spec, "kind_module", lambda package, kind: (
        port if (package, kind) == ("port", "hybrid_test")
        else plain(package, kind)))
    arch = arch_of(HYBRID)
    cfg = arch.cfg
    assert ("attn", "mlp") in cfg.superblock
    assert ("mamba", "moe") in cfg.superblock
    assert (cfg.d_model, cfg.n_layers, cfg.n_periods, cfg.n_experts) == (
        1024, 8, 1, 4)
    assert (cfg.mamba_d_inner, cfg.mamba_headdim, cfg.mamba_dstate,
            cfg.mamba_chunk) == (2048, 64, 64, 128)
    assert arch.mamba.nheads == 32
    with torch.device("meta"):
        params = arch.init(None)
    assert params
