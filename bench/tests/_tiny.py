"""Tiny versions of the benchmark's cells, for the CPU tests: the cells'
configuration and mix files with every size cut down."""
import dataclasses
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import json  # noqa: E402

from bench.harness import spec, train  # noqa: E402
from bench.harness.traffic import load_mix  # noqa: E402

TINY = {
    "bert": dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                 intermediate_size=128, vocab_size=512,
                 max_position_embeddings=128),
    "decoder_moe": dict(hidden_size=64, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=2,
                        intermediate_size=32, num_local_experts=8,
                        num_experts_per_tok=2, vocab_size=512,
                        attention_multiplier=0.25),
}
FP32 = {"policy": "fp32", "param_dtype": "float32",
        "compute_dtype": "float32"}


def tiny_job(cell: str, fp32: bool = False) -> train.Job:
    """The job of `cell` ("<config>.<traffic>", a cell of BENCHMARK.json
    or a pair of files a later cell may use) at a size the CPU runs in
    seconds (fp32: the configuration's precision float32 throughout)."""
    config, traffic = cell.split(".", 1)
    mix = load_mix(spec.BENCH / "traffic" / f"{traffic}.json")
    job = train.Job(cell, json.loads(
        (spec.BENCH / "configs" / f"{config}.json").read_text()), mix,
        mix.data, [])
    conf = {**job.conf, **TINY[job.conf["reference"]]}
    if fp32:
        conf["precision"] = {**conf["precision"], **FP32}
    mix = job.mix
    if mix.kind == "mlm":
        mix = dataclasses.replace(mix, batch=8 // mix.data, seq_len=32,
                                  docs=64, doc_len=96)
    else:
        mix = dataclasses.replace(mix, batch=2, seq_len=64, docs=16,
                                  doc_len=65)
    return dataclasses.replace(job, conf=conf, mix=mix)
