"""Roofline terms of a traced step: the counterpart of
repro/launch/hlo_analysis.py, on the card's constants (launch/mesh.py:
NVIDIA H100 SXM).

launch/trace_cost.py counts a step's FLOPs (by the dtype they run in),
its bytes and its collectives' bytes as the step runs. The roofline
terms, per card, are

  compute    = sum over dtypes of FLOPs / that dtype's peak (bf16 and
               fp16 matmuls at 989 TFLOP/s, TF32 at 495, fp32 and the
               elementwise ops at 67: an fp32 step and a step whose
               matmuls run in bf16 differ 15x in peak)
  memory     = bytes / HBM_BW
  collective = collective bytes / NVLINK_BW

`analyze_trace` turns a Tracer into the dry run's record, with the JAX
record's keys where their meaning holds, plus `flops_by_dtype`.
"""
from __future__ import annotations

import re
from typing import Dict, Iterable, Union

from repro_torch.launch import mesh as mesh_lib


def roofline_terms(flops: Union[float, Dict[str, float]],
                   bytes_accessed: float, coll_bytes_total: float,
                   n_chips: int) -> Dict[str, float]:
    """Roofline seconds. Inputs are GLOBAL totals; divide by card count
    (pass n_chips=1 for one rank's program). `flops` is a number, charged
    at the bf16 peak (the JAX package's single peak), or FLOPs by dtype
    (trace_cost.Cost.flops_by_dtype), each charged at its own peak."""
    by_dtype = flops if isinstance(flops, dict) else {"bfloat16": flops}
    compute_s = sum(f / mesh_lib.PEAK_FLOPS[dt]
                    for dt, f in by_dtype.items()) / n_chips
    memory_s = bytes_accessed / (n_chips * mesh_lib.HBM_BW)
    collective_s = coll_bytes_total / (n_chips * mesh_lib.NVLINK_BW)
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom
    terms["bound_s"] = terms[dom]
    return terms


def model_flops_training(n_params_active: int, n_tokens: int) -> float:
    """6*N*D — the standard training-FLOPs estimate (fwd 2ND + bwd 4ND)."""
    return 6.0 * n_params_active * n_tokens


def model_flops_inference(n_params_active: int, n_tokens: int) -> float:
    return 2.0 * n_params_active * n_tokens


def _as_line(name: str) -> str:
    """An op name ("aten.scatter.src", "c10d.allreduce_.default") as an
    HLO-like line, its namespace kept and its overload dropped."""
    parts = name.replace("::", ".").split(".")
    return f"%op = {'.'.join(parts[:2])}("


def op_counts(ops: Union[str, Iterable[str]],
              kinds=("scatter",)) -> Dict[str, int]:
    """Count ops of the named kinds: in an HLO-style text (one op per line,
    "name = op(...)"), or in an iterable of op names such as
    "aten.scatter.src" (one per op run). The JAX package's matching
    rule: the kind must START the op name (after an optional namespace)
    and the name must end there, so "scatter" does not match
    reduce_scatter / reduce-scatter and "gather" does not match
    all_gather."""
    lines = (ops.splitlines() if isinstance(ops, str)
             else [_as_line(n) for n in ops])
    counts = {k: 0 for k in kinds}
    for line in lines:
        m = re.match(r"^(%?[\w.\-\"]+)\s*=\s*(.*)$", line.strip())
        if not m:
            continue
        rhs = m.group(2)
        for k in kinds:
            if re.search(rf'(?:^|[^\w.\-])(?:\w+\.)?{k}"?\(', rhs):
                counts[k] += 1
    return counts


def tree_bytes(tree) -> int:
    """Bytes of the distinct storages of a tree's tensors (a DTensor's
    local shard): what the tree holds on its device."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_flatten
    seen, total = set(), 0
    for t in tree_flatten(tree)[0]:
        if not isinstance(t, torch.Tensor):
            continue
        if isinstance(t, DTensor):
            t = t.to_local()
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += st.nbytes()
    return total


def analyze_trace(tracer, n_chips: int, arguments, outputs) -> dict:
    """The dry run's record of one rank's traced program (a
    trace_cost.Tracer): costs per card and global, the roofline terms,
    and the memory analysis of `arguments` (the params, optimizer state,
    batch and cache the step takes: argument bytes), `outputs` (output
    bytes) and the traced peak of live bytes (temp bytes, outputs
    included while they are made), with `fits` against the card's
    HBM."""
    cost = tracer.cost
    coll = {k: float(v) for k, v in cost.coll.items()}
    coll_total = sum(coll.values())
    arg_bytes = tree_bytes(arguments)
    mem = {"argument_size_in_bytes": arg_bytes,
           "output_size_in_bytes": tree_bytes(outputs),
           "temp_size_in_bytes": int(tracer.peak_bytes)}
    mem["peak_bytes"] = arg_bytes + mem["temp_size_in_bytes"]
    mem["fits"] = mem["peak_bytes"] <= mesh_lib.HBM_BYTES
    return {
        "flops": cost.flops,                       # per card
        "flops_global": cost.flops * n_chips,
        "flops_by_dtype": dict(cost.flops_by_dtype),
        "bytes_accessed": cost.bytes,              # per card
        "collective_bytes": coll,
        "collective_counts": {k: int(v) for k, v in
                              cost.coll_counts.items()},
        "collective_bytes_total": coll_total,
        "kernels": {k: int(v) for k, v in cost.kernels.items()},
        "memory_analysis": mem,
        "roofline": roofline_terms(cost.flops_by_dtype, cost.bytes,
                                   coll_total, n_chips=1),
        "n_chips": n_chips,
    }
