"""The device trace of a short stretch of steps: torch.profiler over CPU
and CUDA, exported as a Chrome trace into TMPDIR, read and deleted.

Two readings of it:
  - `timeline`: the stretch's wall time (a "bench.stretch" annotation
    around the steps, closed by a synchronize), the union of the device
    operations' intervals in it (kernels, copies, sets), the device
    operations that took most time, and the idle gaps named by what the
    host's thread was running when each began;
  - `attribute`: each device operation with the tags of the metrics whose
    modules launched it. A kernel's launch (the runtime call with its
    correlation id, on the launching thread) lies inside Python frames
    recorded with with_stack=True; a metric's module entry
    "repro_torch/<file>.py" matches a frame of that file, and
    "repro_torch/<file>.py:<function>" a frame of that function. A
    kernel the autograd engine launched has no frames and no tag.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import pathlib
import tempfile
from typing import Callable, Dict, List, Sequence

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
STRETCH = "bench.stretch"


@dataclasses.dataclass
class Op:
    name: str
    start: float   # us, the trace's clock
    dur: float     # us
    tags: frozenset = frozenset()

    @property
    def nccl(self) -> bool:
        return self.name.lower().startswith("nccl")


def record(torch, step: Callable[[], None], steps: int,
           with_stack: bool) -> List[dict]:
    """The trace events of `steps` calls of `step`, inside a
    "bench.stretch" annotation that ends after a synchronize."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_stack=with_stack) as prof:
        with record_function(STRETCH):
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        pathlib.Path(path).unlink(missing_ok=True)


def _stretch(events):
    for e in events:
        if e.get("name") == STRETCH and e.get("ph") == "X" \
                and e.get("cat") != "gpu_user_annotation":
            return e
    raise ValueError("the trace holds no bench.stretch annotation")


def device_ops(events, lo: float, hi: float) -> List[Op]:
    out = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            s, d = float(e["ts"]), float(e.get("dur", 0.0))
            if s + d > lo and s < hi:
                out.append(Op(e["name"], s, d))
    return out


def union(ops: Sequence[Op], lo: float, hi: float):
    """(busy us, [(gap start, gap end)]) of the ops' intervals clipped to
    [lo, hi]."""
    spans = sorted((max(o.start, lo), min(o.start + o.dur, hi)) for o in ops)
    busy, gaps, at = 0.0, [], lo
    for s, e in spans:
        if e <= at:
            continue
        if s > at:
            gaps.append((at, s))
            at = s
        busy += e - at
        at = e
    if at < hi:
        gaps.append((at, hi))
    return busy, gaps


def _host_at(events, tid, gaps):
    """For each gap, the innermost CPU op of thread `tid` open at its start,
    else "python" (the host ran Python between ops)."""
    ops = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                  e["name"]) for e in events
                 if e.get("ph") == "X" and e.get("cat") == "cpu_op"
                 and e.get("tid") == tid)
    names, i, stack = [], 0, []
    for g0, _ in gaps:
        while i < len(ops) and ops[i][0] <= g0:
            stack.append(ops[i])
            i += 1
        stack = [o for o in stack if o[1] > g0]
        names.append(stack[-1][2] if stack else "python")
    return names


@dataclasses.dataclass
class Timeline:
    window_us: float
    busy_us: float
    top_ops: List[list]
    idle_by_host: List[list]
    remainder_us: float


def timeline(events) -> Timeline:
    st = _stretch(events)
    lo, hi = float(st["ts"]), float(st["ts"]) + float(st["dur"])
    ops = device_ops(events, lo, hi)
    busy, gaps = union(ops, lo, hi)
    idle = sum(b - a for a, b in gaps)
    by_op = collections.Counter()
    for o in ops:
        by_op[o.name] += (min(o.start + o.dur, hi) - max(o.start, lo))
    by_host = collections.Counter()
    for (a, b), name in zip(gaps, _host_at(events, st.get("tid"), gaps)):
        by_host[f"host: {name}"] += b - a
    top = lambda c: [[n, us / 1e6] for n, us in c.most_common(10)]
    return Timeline(window_us=hi - lo, busy_us=busy, top_ops=top(by_op),
                    idle_by_host=top(by_host),
                    remainder_us=(hi - lo) - busy - idle)


def _matcher(entries: Sequence[str]):
    files = [e for e in entries if ":" not in e]
    funcs = [tuple(e.split(":", 1)) for e in entries if ":" in e]

    def match(frame: str) -> bool:
        return (any(f + "(" in frame for f in files)
                or any(f + "(" in frame and frame.endswith("): " + fn)
                       for f, fn in funcs))
    return match


def attribute(events, modules: Dict[str, Sequence[str]]) -> List[Op]:
    """The stretch's device operations, each tagged with the names of the
    `modules` entries ({tag: module entries}) that match a Python frame
    around its launch."""
    st = _stretch(events)
    lo, hi = float(st["ts"]), float(st["ts"]) + float(st["dur"])
    ops = device_ops(events, lo, hi)
    corr = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            c = e.get("args", {}).get("correlation")
            if c is not None:
                corr[(e["name"], float(e["ts"]))] = c
    launch = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS:
            c = e.get("args", {}).get("correlation")
            if c is not None:
                launch[c] = (e.get("tid"), float(e["ts"]))
    frames = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "python_function":
            frames[e.get("tid")].append((float(e["ts"]),
                                         float(e["ts"]) + float(e["dur"]),
                                         e["name"]))
    matchers = {tag: _matcher(m) for tag, m in modules.items()}
    # launches per thread in time order, each given the frames open then
    want = collections.defaultdict(list)
    for i, o in enumerate(ops):
        c = corr.get((o.name, o.start))
        if c in launch:
            tid, ts = launch[c]
            want[tid].append((ts, i))
    for tid, points in want.items():
        fr = sorted(frames.get(tid, []))
        points.sort()
        j, stack = 0, []
        for ts, i in points:
            while j < len(fr) and fr[j][0] <= ts:
                stack.append(fr[j])
                j += 1
            stack = [f for f in stack if f[1] >= ts]
            names = [f[2] for f in stack]
            ops[i].tags = frozenset(tag for tag, m in matchers.items()
                                    if any(m(n) for n in names))
    return ops
