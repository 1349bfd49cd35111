"""BENCHMARK.json and the files it names: each cell's configuration,
traffic mix and per-layer metrics, found by name.

  configs/<config>.json   the configuration as it is run
  traffic/<mix>.json      the traffic mix (harness/traffic.py)
  metrics/<metric>.py     one reader per per-layer metric
  cost/<kind>.py, reference/<kind>.py   named by the configuration
  port/<kind>.py          the port's config of the configuration's
                          reference kind (harness/program.py:arch_of)
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import pathlib
import re
from typing import List

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"bad name {name!r}: 1-64 of A-Z a-z 0-9 _ . -, "
                         f"not starting with . or -")
    return name


def check_unit(unit: str) -> str:
    if not isinstance(unit, str) or not UNIT.fullmatch(unit):
        raise ValueError(f"bad unit {unit!r}: 1-16 of A-Z a-z 0-9 _ / % . -")
    return unit


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    layer: str = ""
    moves: str = ""
    workloads: tuple = ()


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: str
    traffic: str
    chips: int
    end_to_end: List[Metric]
    per_layer: List[Metric]

    @property
    def config_path(self) -> pathlib.Path:
        return BENCH / "configs" / f"{self.config}.json"

    @property
    def traffic_path(self) -> pathlib.Path:
        return BENCH / "traffic" / f"{self.traffic}.json"

    def load_config(self) -> dict:
        return json.loads(self.config_path.read_text())


def _metric(raw: dict) -> Metric:
    return Metric(name=check_name(raw["name"]), unit=check_unit(raw["unit"]),
                  better=raw["better"], source=raw["source"],
                  layer=raw.get("layer", ""), moves=raw.get("moves", ""),
                  workloads=tuple(raw.get("workloads", ())))


def load(path: pathlib.Path = ROOT / "BENCHMARK.json") -> dict:
    return json.loads(path.read_text())


def cells(bench: dict) -> List[Cell]:
    """Every cell of `bench` with the metrics it reports, names and units
    checked."""
    for c in bench["configs"]:
        check_name(c["name"])
    e2e = [_metric(m) for m in bench["end_to_end"]]
    per = [_metric(m) for m in bench["per_layer"]]
    out = []
    for w in bench["workloads"]:
        name = check_name(w["name"])
        check_name(w["config"])
        check_name(w["traffic"])
        mine = lambda ms: [m for m in ms
                           if not m.workloads or name in m.workloads]
        out.append(Cell(name=name, config=w["config"], traffic=w["traffic"],
                        chips=int(w["chips"]), end_to_end=mine(e2e),
                        per_layer=mine(per)))
    return out


def cell(name: str, bench: dict = None) -> Cell:
    for c in cells(bench if bench is not None else load()):
        if c.name == name:
            return c
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metric_module(name: str):
    """bench/metrics/<name>.py (a '.' in the name becomes '_')."""
    return importlib.import_module(
        f"bench.metrics.{name.replace('.', '_').replace('-', '_')}")


def all_metric_modules():
    """Every reader under bench/metrics/, by module name."""
    return {p.stem: importlib.import_module(f"bench.metrics.{p.stem}")
            for p in sorted((BENCH / "metrics").glob("*.py"))
            if p.stem != "__init__"}


def kind_module(package: str, kind: str):
    """bench/<package>/<kind>.py: a configuration's cost, reference or
    port module."""
    check_name(kind)
    return importlib.import_module(f"bench.{package}.{kind}")
