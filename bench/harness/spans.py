"""The program's own spans in a traced stretch: device time, idle time and
host time by the "repro/<name>" ranges that the port opens
(repro_torch/metrics/spans.py), read from a stretch traced without
Python stacks, where the host runs at its own pace.

  - device time: each device operation goes, through its launch (the
    runtime call with its correlation id, on the launching thread, at
    its time), to the innermost program span open on that thread then.
    Where operations overlap, each instant of busy time is the
    operation's that started first, so that the spans' time and what
    lies outside them sum to the stretch's busy time.
  - passes: a launch inside an autograd node on its thread (an
    "autograd::engine::evaluate_function: ..." range) is the backward
    pass: the node's "Sequence number" and "Fwd thread id" name the
    forward operation it differentiates, and that operation's spans are
    the launch's, in the backward pass. A span opened inside such a
    node is a checkpointed region run again, and a launch in it is that
    span's recomputation. Any other launch is the span's own pass
    ("forward", the update's included).
  - idle time: each gap in the union of the device operations goes to
    the innermost span open at its start on the thread that launched
    the operation ending it (the host was running that span's code);
    where that thread has none open, to the main thread's (the
    stretch's), and failing that to "outside". The gaps are also
    grouped by the train.* phase open on the main thread at their start.
  - host time: the wall time of each span's ranges, and their number.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from bench.harness import trace

PREFIX = "repro/"
EVAL = "autograd::engine::evaluate_function: "
FORWARD, RECOMPUTE, BACKWARD = "forward", "recompute", "backward"
PASSES = (FORWARD, RECOMPUTE, BACKWARD)
PHASES = ("train.forward", "train.backward", "train.update")
OUTSIDE = "outside"
# a span's context: (its path of span names, outermost first; its pass)
Context = Tuple[Tuple[str, ...], str]


@dataclasses.dataclass
class Report:
    """A stretch's time by span. Keys of `device_us` and `idle_us` are
    (path, pass), the path () for what lies outside every span."""
    steps: int
    window_us: float
    busy_us: float
    idle_total_us: float
    device_us: Dict[Context, float]
    idle_us: Dict[Context, float]
    idle_by_phase: Dict[str, float]
    host_us: Dict[str, float]
    span_counts: Dict[str, int]

    def layer_ms(self, name: str) -> Optional[float]:
        """Device ms a step of every pass of span `name` and the spans
        nested in it; None where the stretch never opened it."""
        if name not in self.span_counts:
            return None
        us = sum(v for (path, _), v in self.device_us.items()
                 if name in path)
        return us / 1e3 / self.steps

    def idle_ms(self, phase: str) -> Optional[float]:
        """Idle ms a step in gaps that began inside train.* `phase` on
        the main thread; None where the stretch never opened it."""
        if phase not in self.span_counts:
            return None
        return self.idle_by_phase.get(phase, 0.0) / 1e3 / self.steps

    def host_ms(self, prefix: str) -> Optional[float]:
        """Host ms a step inside the spans whose names start with
        `prefix`; None where there are none."""
        names = [n for n in self.span_counts if n.startswith(prefix)]
        if not names:
            return None
        return sum(self.host_us[n] for n in names) / 1e3 / self.steps


def _intervals(events):
    """{tid: [(start, end, kind, item)]} by start: the program's spans
    (kind "span", item its name) and the autograd nodes (kind "eval",
    item (Fwd thread id, Sequence number))."""
    out = collections.defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        name, cat = e.get("name", ""), e.get("cat")
        s = float(e["ts"])
        end = s + float(e.get("dur", 0.0))
        if cat == "user_annotation" and name.startswith(PREFIX):
            out[e.get("tid")].append((s, end, "span", name[len(PREFIX):]))
        elif cat == "cpu_op" and name.startswith(EVAL):
            a = e.get("args", {})
            out[e.get("tid")].append(
                (s, end, "eval", (a.get("Fwd thread id"),
                                  a.get("Sequence number"))))
    for v in out.values():
        v.sort(key=lambda x: (x[0], -x[1]))
    return out


def _open_at(intervals, times: Sequence[float]) -> List[list]:
    """For each time in `times`, the intervals open then (start <= t <
    end), outermost first."""
    order = sorted(range(len(times)), key=lambda i: times[i])
    res = [None] * len(times)
    j, stack = 0, []
    for i in order:
        t = times[i]
        while j < len(intervals) and intervals[j][0] <= t:
            stack.append(intervals[j])
            j += 1
        stack = [o for o in stack if o[1] > t]
        res[i] = list(stack)
    return res


def _forward_ops(events, intervals):
    """{(tid, Sequence number): the time of the forward operation that
    made the autograd node of that number}: of the operations that carry
    the number and lie in no autograd node of their thread (a node's own
    operations and a recomputation's are not the forward pass), the
    last; an operation that makes no node carries the number the next
    node will take."""
    cands = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "cpu_op" \
                and not e.get("name", "").startswith(EVAL):
            seq = e.get("args", {}).get("Sequence number")
            if seq is not None:
                cands[e.get("tid")].append((float(e["ts"]), seq))
    out = {}
    for tid, ops in cands.items():
        opened = _open_at(intervals.get(tid, []), [t for t, _ in ops])
        for (t, seq), op in zip(ops, opened):
            if not any(o[2] == "eval" for o in op):
                out[(tid, seq)] = max(t, out.get((tid, seq), t))
    return out


def _thread_map(intervals, fwd) -> Dict:
    """{Fwd thread id: tid}: the profiler's own number of a forward
    thread, as the autograd nodes give it, to the trace's thread id,
    taken as the thread whose forward operations carry the most of
    those nodes' sequence numbers."""
    seqs = collections.defaultdict(set)
    for (tid, seq) in fwd:
        seqs[seq].add(tid)
    votes = collections.defaultdict(collections.Counter)
    for ivs in intervals.values():
        for _, _, kind, item in ivs:
            if kind == "eval":
                for tid in seqs.get(item[1], ()):
                    votes[item[0]][tid] += 1
    return {fid: c.most_common(1)[0][0] for fid, c in votes.items()}


class _Resolver:
    """The context (path, pass) of a thread at a time."""

    def __init__(self, events, main_tid):
        self.main = main_tid
        self.iv = _intervals(events)
        fwd = _forward_ops(events, self.iv)
        tmap = _thread_map(self.iv, fwd)
        times = collections.defaultdict(list)
        for (tid, seq), t in fwd.items():
            times[tid].append((t, seq))
        self.fwd_path = {}
        for tid, pts in times.items():
            opened = _open_at(self.iv.get(tid, []), [t for t, _ in pts])
            for (_, seq), op in zip(pts, opened):
                self.fwd_path[(tid, seq)] = tuple(
                    o[3] for o in op if o[2] == "span")
        self.tmap = tmap

    def _backward(self, item) -> Tuple[str, ...]:
        fid, seq = item
        tid = self.tmap.get(fid)
        return self.fwd_path.get((tid, seq), ()) if tid is not None else ()

    def contexts(self, tid, times) -> List[Optional[Context]]:
        """The context on `tid` at each time: None where the thread has no
        span open and is in no autograd node whose forward op lay in a
        span. A node with no such op gives ((), backward)."""
        out = []
        for opened in _open_at(self.iv.get(tid, []), times):
            spans = [o for o in opened if o[2] == "span"]
            evals = [o for o in opened if o[2] == "eval"]
            if evals:
                node = evals[-1]
                inner = tuple(o[3] for o in spans if o[0] >= node[0])
                if inner:
                    out.append((inner, RECOMPUTE))
                else:
                    out.append((self._backward(node[3]), BACKWARD))
            elif spans:
                out.append((tuple(o[3] for o in spans), FORWARD))
            else:
                out.append(None)
        return out

    def resolve(self, queries: Sequence[Tuple[object, float]]
                ) -> List[Context]:
        """The context of each (tid, time): the thread's own, else the main
        thread's path at that time (keeping a backward pass found on the
        thread), else outside."""
        by_tid = collections.defaultdict(list)
        for i, (tid, t) in enumerate(queries):
            by_tid[tid].append(i)
        res: List[Optional[Context]] = [None] * len(queries)
        for tid, idx in by_tid.items():
            for i, c in zip(idx, self.contexts(tid, [queries[i][1]
                                                     for i in idx])):
                res[i] = c
        todo = [i for i, c in enumerate(res) if c is None or not c[0]]
        main = self.contexts(self.main, [queries[i][1] for i in todo])
        for i, m in zip(todo, main):
            passed = (res[i][1] if res[i] is not None
                      else m[1] if m is not None else FORWARD)
            res[i] = (m[0] if m is not None else (), passed)
        return res

    def phases(self, times) -> List[str]:
        """The innermost train.* phase open on the main thread at each
        time: one of PHASES, "train.step", or outside."""
        out = []
        for opened in _open_at(self.iv.get(self.main, []), times):
            names = [o[3] for o in opened if o[2] == "span"
                     and o[3].startswith("train.")]
            inner = [n for n in names if n in PHASES]
            out.append(inner[-1] if inner else
                       names[-1] if names else OUTSIDE)
        return out


def read(events, steps: int) -> Report:
    """The Report of a stretch's Chrome trace events (trace.record, with
    the "bench.stretch" annotation) of `steps` steps."""
    st = trace._stretch(events)
    lo, hi = float(st["ts"]), float(st["ts"]) + float(st["dur"])
    main = st.get("tid")
    dev = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in trace.DEVICE_CATS:
            s, d = float(e["ts"]), float(e.get("dur", 0.0))
            if s + d > lo and s < hi:
                dev.append((s, d, e.get("args", {}).get("correlation")))
    dev.sort(key=lambda x: x[0])
    launch = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in trace.LAUNCH_CATS:
            c = e.get("args", {}).get("correlation")
            if c is not None:
                launch[c] = (e.get("tid"), float(e["ts"]))
    res = _Resolver(events, main)
    # each op's launching thread and time (the main thread at the op's
    # start where its launch is not in the trace)
    where = [launch.get(c, (main, s)) for s, _, c in dev]
    ctxs = res.resolve(where)
    device = collections.Counter()
    covered = lo
    for (s, d, _), ctx in zip(dev, ctxs):
        a, b = max(s, lo, covered), min(s + d, hi)
        if b > a:
            device[ctx] += b - a
        covered = max(covered, s + d)
    busy, gaps = trace.union([trace.Op("", s, d) for s, d, _ in dev],
                             lo, hi)
    starts = [max(s, lo) for s, _, _ in dev]
    gap_q = []
    for a, b in gaps:
        k = bisect.bisect_left(starts, b)
        gap_q.append((where[k][0] if k < len(dev) else main, a))
    idle = collections.Counter()
    for (a, b), ctx in zip(gaps, res.resolve(gap_q)):
        idle[ctx] += b - a
    by_phase = collections.Counter()
    for (a, b), ph in zip(gaps, res.phases([a for a, _ in gaps])):
        by_phase[ph] += b - a
    host, counts = collections.Counter(), collections.Counter()
    for ivs in res.iv.values():
        for s, e, kind, name in ivs:
            if kind == "span" and e > lo and s < hi:
                host[name] += min(e, hi) - max(s, lo)
                counts[name] += 1
    return Report(steps=steps, window_us=hi - lo, busy_us=busy,
                  idle_total_us=sum(b - a for a, b in gaps),
                  device_us=dict(device), idle_us=dict(idle),
                  idle_by_phase=dict(by_phase), host_us=dict(host),
                  span_counts=dict(counts))


def readings(report: Report, counters: Dict[str, int]) -> Dict[str, float]:
    """The per-layer readings of the spans and of the program's counters
    over the stretch (`counters`: their change over it); a reading with
    nothing to read is left out."""
    routed = counters.get("moe.pairs_routed", 0)
    vals = {
        "attention_ms": report.layer_ms("model.attention"),
        "head_ms": report.layer_ms("model.head"),
        "moe_route_ms": report.layer_ms("model.moe.route"),
        "moe_experts_ms": report.layer_ms("model.moe.experts"),
        "idle_forward_ms": report.idle_ms("train.forward"),
        "idle_backward_ms": report.idle_ms("train.backward"),
        "idle_update_ms": report.idle_ms("train.update"),
        "host_sync_ms": report.host_ms("sync."),
        "moe_drop_share": (100.0 * counters.get("moe.pairs_dropped", 0)
                           / routed if routed else None),
    }
    return {k: v for k, v in vals.items() if v is not None}


def table(report: Report) -> str:
    """The report as text: per innermost span, its ranges a step and
    device ms a step by pass, idle and host ms a step; then the sums
    held against the stretch's busy and idle time."""
    n = report.steps
    rows = collections.defaultdict(lambda: collections.Counter())
    for (path, ps), us in report.device_us.items():
        rows[path[-1] if path else OUTSIDE][ps] += us
    for (path, _), us in report.idle_us.items():
        rows[path[-1] if path else OUTSIDE]["idle"] += us
    names = sorted(set(rows) | set(report.span_counts),
                   key=lambda k: (k == OUTSIDE, k))
    ms = lambda us: f"{us / 1e3 / n:10.3f}"
    lines = [f"{'span':<20}{'n/step':>8}{'forward':>10}{'recompute':>10}"
             f"{'backward':>10}{'idle':>10}{'host':>10}   (ms a step)"]
    for k in names:
        r = rows[k]
        lines.append(
            f"{k:<20}{report.span_counts.get(k, 0) / n:8.1f}"
            + "".join(ms(r[p]) for p in PASSES) + ms(r["idle"])
            + ms(report.host_us.get(k, 0.0)))
    dev = sum(report.device_us.values())
    idle = sum(report.idle_us.values())
    lines.append(f"device by span + outside {dev / 1e3:.3f} ms, busy "
                 f"{report.busy_us / 1e3:.3f} ms; idle by span + outside "
                 f"{idle / 1e3:.3f} ms, idle {report.idle_total_us / 1e3:.3f}"
                 f" ms; stretch {report.window_us / 1e3:.3f} ms, {n} steps")
    lines.append("idle by phase, ms a step: " + ", ".join(
        f"{k} {v / 1e3 / n:.3f}" for k, v in sorted(
            report.idle_by_phase.items())))
    return "\n".join(lines)
