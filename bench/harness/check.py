"""The comparison that decides `correct` for a training cell: the
program's first three steps against the reference's, on the same
weights and rows.

A leaf's gap is the gap between the program's norm and the
reference's, over the larger of the leaf's reference norm and the
median leaf's. Numbers compared, each against its limit
(limits/<cell>.json):
  loss1   the relative gap of the first step's losses (the forward
          pass alone: a batch the program reads in part shows here)
  loss    the largest relative gap of the three steps' losses
  grad    the median leaf's gap of the norms of the first gradient (the
          program's as its optimizer got it, the reference's)
  grad_dir  the largest, among the leaves the configuration names under
          "dense" (the stacked layers), of the norm of the difference of
          the two first gradients over the same denominator: where
          rounding moves a norm only in second order, it moves the
          difference in first, so this reads the precision each layer's
          GEMMs ran in, leaf by leaf
  change  the median leaf's gap of the norms of each leaf's change over
          the three steps, over the leaves whose first reference
          gradient is at least a thousandth of the median leaf's (a key
          bias, whose gradient is nought to rounding, moves by round-off
          alone under LANS's normalised gradient)
  grad0   the largest gap of the first gradient's norms among the leaves
          whose reference gradient is nought to float32 rounding (under a
          millionth of the median leaf's): round-off alone, so its size
          measures the precision the program computes in (absent where
          the model has no such leaf; a leaf that is small by chance, as
          the NSP head's bias on a balanced batch, stays above it)
  watch   the largest change gap among the leaves the configuration
          names under "watch" (BERT's mlm_bias: one entry per vocabulary
          id, so its update follows which tokens a batch masks)
The worst leaf of each is reported beside it and not compared: in bf16
one small leaf reads far off by its nature (PERF.md: the type
embedding's gradient, summed over every position in bf16).
"""
from __future__ import annotations

import json
import statistics
from typing import Dict, List

from bench.harness.spec import BENCH

MOVED_SHARE = 1e-3
NOUGHT_SHARE = 1e-6


def gaps(prog: Dict[str, float], ref: Dict[str, float],
         paths=None) -> Dict[str, float]:
    return shares({p: abs(prog[p] - ref[p]) for p in ref}, ref, paths)


def shares(num: Dict[str, float], ref: Dict[str, float],
           paths=None) -> Dict[str, float]:
    """Each leaf's `num` over the larger of its reference norm and the
    median leaf's."""
    paths = list(ref) if paths is None else list(paths)
    med = statistics.median(ref[p] for p in ref)
    return {p: num[p] / max(ref[p], med, 1e-30) for p in paths}


def _reading(g: Dict[str, float]) -> dict:
    worst = max(g, key=g.get)
    return {"value": statistics.median(g.values()), "worst": g[worst],
            "leaf": worst}


def moved(ref_grad: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grad.values())
    return [p for p, g in ref_grad.items() if g >= MOVED_SHARE * med]


def nought(ref_grad: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grad.values())
    return [p for p, g in ref_grad.items() if g < NOUGHT_SHARE * med]


def numbers(prog: dict, ref: dict, watch=(), dense=()) -> Dict[str, dict]:
    """{number: {"value", "leaf"?}} from the two sides' readings:
    losses [3], grad {path: norm}, change {path: norm}, and on the
    program's side grad_diff {path: norm of the two first gradients'
    difference}; `watch` the configuration's watched leaves, `dense` the
    path prefixes of its dense leaves."""
    rel = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                               ref["losses"])]
    g = gaps(prog["grad"], ref["grad"])
    out = {"loss1": {"value": rel[0]}, "loss": {"value": max(rel)},
           "grad": _reading(g),
           "change": _reading(gaps(prog["change"], ref["change"],
                                   moved(ref["grad"])))}
    if dense:
        d = shares(prog["grad_diff"], ref["grad"],
                   [p for p in ref["grad"] if p.startswith(tuple(dense))])
        worst = max(d, key=d.get)
        out["grad_dir"] = {"value": d[worst], "leaf": worst}
    if watch:
        c = gaps(prog["change"], ref["change"], watch)
        worst = max(c, key=c.get)
        out["watch"] = {"value": c[worst], "leaf": worst}
    zero = nought(ref["grad"])
    if zero:
        worst = max(zero, key=g.get)
        out["grad0"] = {"value": g[worst], "leaf": worst}
    return out


def limits(cell: str) -> Dict[str, float]:
    return json.loads((BENCH / "limits" / f"{cell}.json").read_text())


def judge(nums: Dict[str, dict], lim: Dict[str, float]) -> bool:
    """Every number that has a limit is within it (a number the run
    could not read is not)."""
    return all(k in nums and nums[k]["value"] <= lim[k] for k in lim)
