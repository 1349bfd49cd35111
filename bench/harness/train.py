"""One run of a training cell: set-up, the measured window, the traced
stretches (with --trace 1) and the comparison that decides `correct`.

Set-up builds one Program (the port's train step with its model and
optimizer state, weights made by the benchmark from the seed) and drives
it through its first three steps, on rows that all differ, with the
window's own call and feed; those steps read the program's side of the
comparison (each step's loss, the first gradient as the optimizer got
it, each leaf's change over the three). The same object then runs the
window: steps dispatched back to back, each on the next batch of the
pool copied to the card, until --seconds have passed on the host's
clock, then a synchronize. After the window the program is freed and
the plain reference (reference/<kind>.py, reference/lans.py) follows
the same three steps from the same weights.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import math
import os
import resource
import sys
import time
from typing import Dict, List, Optional

import torch

from bench.cost import lans as lans_cost
from bench.harness import check, spans, spec, trace, weights
from bench.harness.traffic import Mix, load_mix, make_pool
from bench.reference import common as rcommon
from bench.reference import lans as rlans

FIRST_STEPS = 3
TRACE_STEPS = 2
# faults a run can plant in the timed path (the tests' and calibrate.py's
# check that the comparison catches them): each step returns its state as
# it was; half of each batch left out, the mean taken over the rest; the
# BERT feed-forward blocks' GEMMs in float8
FAULTS = (None, "unchanged", "half_batch", "ffn_fp8")


@dataclasses.dataclass
class Job:
    """What a run needs of a cell: its configuration and mix, read from
    their files, and the names of what it reports."""
    name: str
    conf: dict
    mix: Mix
    chips: int
    per_layer: List[str]

    @property
    def ref(self):
        return spec.kind_module("reference", self.conf["reference"])

    @property
    def cost(self):
        return spec.kind_module("cost", self.conf["cost"])


def job_of(cell: spec.Cell) -> Job:
    mix = load_mix(cell.traffic_path)
    if mix.data != 1 or cell.chips != 1:
        raise ValueError(f"{cell.name}: the harness runs cells of one chip "
                         f"and one data rank")
    return Job(cell.name, cell.load_config(), mix, cell.chips,
               [m.name for m in cell.per_layer])


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host_pool(pool_np, device):
    pin = device.type == "cuda"
    return [{k: (torch.from_numpy(v).pin_memory() if pin
                 else torch.from_numpy(v)) for k, v in b.items()}
            for b in pool_np]


class Run:
    """The program's side of a run, from set-up to the end of the
    window."""

    def __init__(self, job: Job, seed: int, device,
                 fault: Optional[str] = None):
        from bench.harness.program import Program
        if fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.job, self.seed, self.device = job, seed, device
        self.fault = fault
        conf, mix = job.conf, job.mix
        self.rc = job.ref.cfg_of(conf)
        self.layout = job.ref.param_layout(self.rc)
        self.pool_np = make_pool(mix, conf["vocab_size"], seed)
        self.pool = _host_pool(self.pool_np, device)
        self.next = 0
        self._undo = _ffn_fp8() if fault == "ffn_fp8" else None
        self.program = Program(
            conf, mix,
            lambda: weights.nest(weights.make(self.layout, conf, seed,
                                              device)))
        if fault == "unchanged":           # a step that keeps its state
            step = self.program.step_fn
            self.program.step_fn = lambda p, s, b: (p, s, step(p, s, b)[2])

    def feed(self):
        """The next batch of the pool, copied to the card."""
        b = self.pool[self.next % len(self.pool)]
        self.next += 1
        if self.fault == "half_batch":
            b = {k: v[:v.shape[0] // 2] for k, v in b.items()}
        return {k: v.to(self.device, non_blocking=True) for k, v in b.items()}

    def first_steps(self) -> dict:
        """The first three steps; the program's readings of them."""
        losses = [self.program.step(self.feed()) for _ in range(FIRST_STEPS)]
        self.program.capture.on = False
        init = weights.make(self.layout, self.job.conf, self.seed,
                            self.device)
        master = self.program.master()
        change = {p: torch.linalg.vector_norm(master[p] - init[p])
                  for p in init}
        del init, master
        cap = self.program.capture
        return {"losses": [float(x) for x in losses],
                "grad": {p: float(v) for p, v in cap.grad_norms.items()},
                "grad_vec": cap.grads,
                "change": {p: float(v) for p, v in change.items()}}

    def window(self, seconds: float) -> dict:
        """Steps back to back for `seconds` on the host's clock, then a
        synchronize: (steps, seconds, host seconds a call, losses). The
        objects set-up left are frozen out of the garbage collector's
        scans (gc.freeze), so that a full collection in the window scans
        only what the window made."""
        sync(self.device)
        gc.collect()
        gc.freeze()
        host, losses, n = [], [], 0
        first = self.next
        cpu0, ru0 = _cpu(), resource.getrusage(resource.RUSAGE_THREAD)
        t0 = time.perf_counter()
        while True:
            b = self.feed()
            a = time.perf_counter()
            losses.append(self.program.step(b))
            host.append(time.perf_counter() - a)
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync(self.device)
        t1 = time.perf_counter()
        ru1 = resource.getrusage(resource.RUSAGE_THREAD)
        gc.unfreeze()
        print(f"host: {len(os.sched_getaffinity(0))} cpus allowed; the "
              f"window's thread ran on cpu {cpu0} -> {_cpu()}, "
              f"{ru1.ru_nivcsw - ru0.ru_nivcsw} involuntary and "
              f"{ru1.ru_nvcsw - ru0.ru_nvcsw} voluntary context switches, "
              f"{ru1.ru_utime - ru0.ru_utime:.3f} s user "
              f"{ru1.ru_stime - ru0.ru_stime:.3f} s system of "
              f"{t1 - t0:.3f} s", file=sys.stderr)
        flops = sum(self.job.cost.step_flops(
            self.job.conf, self.pool_np[(first + i) % len(self.pool_np)])
            for i in range(n))
        bad = sum(not math.isfinite(float(x)) for x in losses)
        return {"steps": n, "seconds": t1 - t0, "host_s": host,
                "flops": flops, "failed": bad}

    def stretch(self, with_stack: bool):
        return trace.record(torch, lambda: self.program.step(self.feed()),
                            TRACE_STEPS, with_stack)

    def counted_stretch(self):
        """The stretch without Python stacks: its events, and the
        program's counters' change over it."""
        from bench.harness.program import counters
        before = counters()
        events = self.stretch(with_stack=False)
        after = counters()
        return events, {k: v - before.get(k, 0) for k, v in after.items()}

    def free(self):
        self.program = None
        self.pool = None
        if self._undo is not None:
            self._undo()
            self._undo = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _cpu() -> int:
    """The CPU this thread last ran on (field 39 of its stat line)."""
    with open("/proc/thread-self/stat") as f:
        return int(f.read().rsplit(")", 1)[1].split()[36])


def _ffn_fp8():
    """The fault "ffn_fp8": the port's BERT feed-forward blocks run their
    two GEMMs in float8 as the control does (reference/common.py: e4m3
    operands, e5m2 output gradients, per-tensor scales, float32 sums)
    and every other layer as before. Returns the undo."""
    from repro_torch.models import bert
    from repro_torch.models.common import ACTIVATIONS
    plain = bert.mlp_apply

    def dense(q, x, cd):
        y = rcommon.FP8.mm(x.float(), q["kernel"].float()).to(cd)
        return y + q["bias"].to(cd) if "bias" in q else y

    def faulty(p, x, *, activation="silu", compute_dtype=torch.bfloat16):
        h = ACTIVATIONS[activation](dense(p["up"], x, compute_dtype))
        return dense(p["down"], h, compute_dtype)
    bert.mlp_apply = faulty
    return lambda: setattr(bert, "mlp_apply", plain)


def _microbatches(batch, n):
    rows = next(iter(batch.values())).shape[0]
    size = rows // n
    return [{k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            for i in range(n)]


def model_copy(x: Dict[str, torch.Tensor], conf: dict) -> Dict[str, torch.Tensor]:
    """The weights the forward pass sees: each master weight rounded to
    the precision its leaf lives in (param_dtype, or float32 for a leaf
    the policy keeps), held in float32."""
    low = weights.LOW[conf["precision"]["param_dtype"]]
    keep = conf["precision"]["keep_fp32"]
    return {p: t if lans_cost.kept_fp32(p, keep) else t.to(low).float()
            for p, t in x.items()}


def reference_readings(job: Job, seed: int, device, pool_np,
                       prec: rcommon.Prec = rcommon.FP32) -> dict:
    """The reference's readings of the first three steps, computed in
    `prec`, from the weights the program started from, on the same rows:
    each step's loss and gradient at the model copy of the float32
    master weights (model_copy), and the LANS update of the masters.
    The first gradient is also kept whole, on the host ("grad_vec")."""
    rcommon.no_tf32()
    rc = job.ref.cfg_of(job.conf)
    layout = job.ref.param_layout(rc)
    init = weights.make(layout, job.conf, seed, device)
    x = {p: t.clone() for p, t in init.items()}
    m = {p: torch.zeros_like(t) for p, t in x.items()}
    v = {p: torch.zeros_like(t) for p, t in x.items()}
    opt = job.conf["optimizer"]
    losses, grad = [], None
    for s in range(FIRST_STEPS):
        b = {k: torch.from_numpy(a).to(device) for k, a in pool_np[s].items()}
        mbs = _microbatches(b, job.mix.microbatches)
        total, g = 0.0, None
        copy = model_copy(x, job.conf)
        for mb in mbs:
            loss, gi = job.ref.loss_and_grads(copy, rc, mb, prec)
            total += loss
            if g is None:
                g = gi
            else:
                for p in g:
                    g[p] += gi[p]
            del gi
        for p in g:
            g[p] /= len(mbs)
        losses.append(total / len(mbs))
        if s == 0:
            grad = {p: float(torch.linalg.vector_norm(t)) for p, t in g.items()}
            vec = {p: t.to("cpu", copy=True) for p, t in g.items()}
        del copy
        rlans.update(x, g, m, v, s + 1, rlans.schedule(job.mix.schedule, s),
                     opt)
        del g
    change = {p: float(torch.linalg.vector_norm(x[p] - init[p])) for p in x}
    return {"losses": losses, "grad": grad, "grad_vec": vec,
            "change": change}


def grad_diffs(side: dict, ref: dict, device) -> Dict[str, float]:
    """{path: norm of (side's first gradient - the reference's)}, leaf by
    leaf on the device, from the two host copies ("grad_vec")."""
    a, b = side["grad_vec"], ref["grad_vec"]
    return {p: float(torch.linalg.vector_norm(
        a[p].to(device).float() - b[p].to(device))) for p in b}


def watched(conf: dict) -> tuple:
    return tuple(conf.get("watch", {}).get("leaves", ()))


def dense(conf: dict) -> tuple:
    return tuple(conf.get("dense", {}).get("leaves", ()))


class Ctx:
    """What the per-layer readers read (metrics/<name>.py)."""
    spans = None      # the stretch without stacks by span (spans.Report)
    counters = None   # the program's counters' change over that stretch

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def tagged_ms(self, tag: str) -> float:
        return sum(o.dur for o in self.ops if tag in o.tags) / 1e3 \
            / self.traced_steps

    def span_readings(self) -> Dict[str, float]:
        """spans.readings of the stretch; none where the run traced
        none."""
        if self.spans is None:
            return {}
        return spans.readings(self.spans, self.counters or {})


def _modules() -> Dict[str, tuple]:
    return {name: mod.MODULES for name, mod in
            spec.all_metric_modules().items() if hasattr(mod, "MODULES")}


def run(job: Job, seed: int, seconds: float, traced: bool, *, device,
        t_start: float, fault: Optional[str] = None) -> dict:
    """One run, with `fault` (FAULTS) planted in the timed path where one
    is named."""
    run_ = Run(job, seed, device, fault)
    prog = run_.first_steps()
    sync(device)
    setup_s = time.perf_counter() - t_start
    setup_peak = (torch.cuda.max_memory_allocated(device)
                  if device.type == "cuda" else 0)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    w = run_.window(seconds)
    window_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    tl, ops, report, counts = None, [], None, None
    if traced:
        events, counts = run_.counted_stretch()
        tl = trace.timeline(events)
        report = spans.read(events, TRACE_STEPS)
        del events
        ops = trace.attribute(run_.stretch(with_stack=True), _modules())
        tagged = sum(o.dur for o in ops if o.tags)
        print(f"trace: {len(ops)} device ops in {TRACE_STEPS} steps, "
              f"{tagged / 1e3:.3f} ms tagged; stretch "
              f"{tl.window_us / 1e3:.3f} ms, busy {tl.busy_us / 1e3:.3f} ms, "
              f"unaccounted {tl.remainder_us / 1e3:.6f} ms", file=sys.stderr)
        opt = collections.Counter()
        for o in ops:
            if "lans_update_ms" in o.tags:
                opt[o.name[:100]] += o.dur / 1e3 / TRACE_STEPS
        print(f"optimizer's device ops, ms a step: {opt.most_common(8)}",
              file=sys.stderr)
    peak = max(setup_peak, torch.cuda.max_memory_allocated(device)
               if device.type == "cuda" else 0)
    pool_np = run_.pool_np
    run_.free()
    ref = reference_readings(job, seed, device, pool_np)
    prog["grad_diff"] = grad_diffs(prog, ref, device)
    nums = check.numbers(prog, ref, watched(job.conf), dense(job.conf))
    try:
        lim = check.limits(job.name)
    except FileNotFoundError:
        lim = {k: 0.0 for k in nums}
    correct = check.judge(nums, lim) and w["failed"] == 0
    tokens = w["steps"] * job.mix.tokens_per_step
    result = {"correct": correct, "attempted": w["steps"],
              "failed": w["failed"]}
    if traced:
        ctx = Ctx(host_s=w["host_s"], window_s=w["seconds"],
                  window_flops=w["flops"], chips=job.chips, ops=ops,
                  traced_steps=TRACE_STEPS, timeline=tl, spans=report,
                  counters=counts,
                  lans_bytes=lans_cost.update_bytes(job.conf, run_.layout),
                  window_peak_bytes=window_peak)
        metrics = {}
        for name in job.per_layer:
            mod = spec.metric_module(name)
            val = mod.read(ctx)
            if val is not None:
                metrics[name] = {"value": val, "unit": mod.UNIT}
        result["metrics"] = metrics
    else:
        result["metrics"] = {
            "train_tokens_per_s": {"value": tokens / w["seconds"],
                                   "unit": "tokens/s"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": job.chips, "memory_peak_bytes": peak}
    if traced:
        dev["busy_s"] = tl.busy_us / 1e6
        dev["window_s"] = tl.window_us / 1e6
        result["breakdown"] = {"device_ops": tl.top_ops,
                               "idle_gaps": tl.idle_by_host}
    result["device"] = dev
    result["check"] = {k: {"value": nums[k]["value"], "limit": lim.get(k)}
                       for k in sorted(nums, key=lambda k: k not in lim)}
    print(f"losses {prog['losses']}, reference {ref['losses']}",
          file=sys.stderr)
    for k in nums:
        if "worst" in nums[k]:
            print(f"{k}: median leaf {nums[k]['value']!r}, worst leaf "
                  f"{nums[k]['leaf']} {nums[k]['worst']!r} (not compared)",
                  file=sys.stderr)
    return result
