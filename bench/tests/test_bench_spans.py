"""The span reader (harness/spans.py) on a hand-made Chrome trace: nested
spans, a backward node joined to its forward op by its sequence number,
a recomputed range, gaps ending with ops of the autograd engine's
thread, overlapping ops and time outside every span; each reading from
it; the existing readers unchanged with the stretch's events and the
counters beside them; and a real CPU trace of a tiny step, its matmuls
standing in for device ops."""
import json

import pytest
import torch

from bench.harness import spans, trace, train
from bench.tests._tiny import tiny_job

MAIN, ENGINE, STREAM = 1, 2, 7
# the readers over spans.readings (bench/metrics/<name>.py)
SPAN_READINGS = ("attention_ms", "head_ms", "moe_route_ms", "moe_experts_ms",
                 "moe_drop_share", "idle_forward_ms", "idle_backward_ms",
                 "idle_update_ms", "host_sync_ms")


def ev(cat, name, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def sp(name, ts, dur, tid=MAIN):
    return ev("user_annotation", spans.PREFIX + name, ts, dur, tid)


def op(name, ts, dur, seq, tid=MAIN):
    return ev("cpu_op", name, ts, dur, tid, **{"Sequence number": seq,
                                               "Fwd thread id": 0})


def node(name, ts, dur, seq):
    return ev("cpu_op", spans.EVAL + name, ts, dur, ENGINE,
              **{"Sequence number": seq, "Fwd thread id": 1})


def launch(ts, corr, tid=MAIN):
    return ev("cuda_runtime", "cudaLaunchKernel", ts, 0.5, tid,
              correlation=corr)


def kernel(ts, dur, corr):
    return ev("kernel", f"k{corr}", ts, dur, STREAM, correlation=corr)


EVENTS = [
    ev("user_annotation", trace.STRETCH, 0, 200),
    sp("train.step", 5, 185),
    sp("train.forward", 10, 50),
    op("aten::empty", 11, 0.5, 10),          # makes no node: peeks 10
    sp("model.attention", 12, 18),
    op("aten::mm", 14, 2, 10), launch(15, 1),
    sp("model.moe.route", 31, 3),
    sp("model.moe.experts", 35, 15),
    op("aten::addmm", 36, 2, 11), launch(37, 2),
    sp("sync.moe_counts", 40, 5), launch(41, 3),
    op("aten::mul", 52, 1, 12), launch(52.5, 4),
    sp("train.backward", 60, 90),
    node("MulBackward0", 62, 8, 12), launch(63, 5, ENGINE),
    node("MmBackward0", 70, 40, 10),
    sp("model.attention", 72, 18, ENGINE),   # the layer recomputed
    op("aten::mm", 74, 2, 12, ENGINE),       # the engine's own numbers
    launch(75, 6, ENGINE),
    launch(95, 7, ENGINE), launch(96, 10, ENGINE),
    launch(104.5, 12, ENGINE),
    launch(112, 11, ENGINE),                 # in no node and no span
    sp("train.update", 150, 35), launch(155, 8),
    launch(192, 9),                          # the harness's feed
    kernel(20, 10, 1), kernel(38, 4, 2), kernel(42, 5, 3), kernel(55, 3, 4),
    kernel(64, 4, 5), kernel(76, 10, 6), kernel(96, 4, 7),
    kernel(98, 6, 10), kernel(105, 6, 12), kernel(115, 3, 11),
    kernel(160, 10, 8), kernel(193, 3, 9),
]
F, R, B = spans.FORWARD, spans.RECOMPUTE, spans.BACKWARD
STEP, FWD = ("train.step",), ("train.step", "train.forward")
ATTN = FWD + ("model.attention",)


def test_device_time_by_span_and_pass():
    r = spans.read(EVENTS, 1)
    assert r.window_us == 200 and r.busy_us == 66
    assert r.device_us == {
        (ATTN, F): 10,
        (FWD + ("model.moe.experts",), F): 4,
        (FWD + ("model.moe.experts", "sync.moe_counts"), F): 5,
        (FWD, F): 3,
        (FWD, B): 4,                              # MulBackward0 -> aten::mul
        (("model.attention",), R): 10,
        (ATTN, B): 4 + 4 + 6,        # k10 overlaps k7 by 2 us: counted once
        (STEP + ("train.backward",), F): 3,       # the main thread's
        (STEP + ("train.update",), F): 10,
        ((), F): 3}
    assert sum(r.device_us.values()) == r.busy_us


def test_idle_gaps_by_span_and_phase():
    r = spans.read(EVENTS, 1)
    assert r.idle_total_us == 134
    assert r.idle_us == {
        ((), F): 20 + 4,
        (FWD, F): 8 + 6,
        (FWD + ("model.moe.experts",), F): 8,
        (FWD, B): 8,                # ended by the engine, in MulBackward0
        (("model.attention",), R): 10,
        (ATTN, B): 1,
        (STEP + ("train.backward",), F): 4 + 42,
        (STEP + ("train.update",), F): 23}
    assert r.idle_by_phase == {"outside": 24, "train.forward": 22,
                               "train.backward": 65, "train.update": 23}
    assert sum(r.idle_us.values()) == r.idle_total_us
    assert r.busy_us + r.idle_total_us == r.window_us


def test_host_time_and_counts():
    r = spans.read(EVENTS, 1)
    assert r.span_counts["model.attention"] == 2
    assert r.host_us["model.attention"] == 36
    assert r.host_us["sync.moe_counts"] == 5


def test_readings():
    r = spans.read(EVENTS, 2)
    got = spans.readings(r, {"moe.pairs_routed": 400,
                             "moe.pairs_dropped": 10})
    assert got == pytest.approx({
        "attention_ms": 34e-3 / 2, "moe_route_ms": 0.0,
        "moe_experts_ms": 9e-3 / 2, "idle_forward_ms": 22e-3 / 2,
        "idle_backward_ms": 65e-3 / 2, "idle_update_ms": 23e-3 / 2,
        "host_sync_ms": 5e-3 / 2, "moe_drop_share": 2.5})
    # no head span, no MoE pairs: nothing to read
    assert "head_ms" not in got
    assert "moe_drop_share" not in spans.readings(r, {})


def test_table_holds_the_sums():
    text = spans.table(spans.read(EVENTS, 1))
    assert "device by span + outside 0.066 ms, busy 0.066 ms" in text
    assert "idle by span + outside 0.134 ms, idle 0.134 ms" in text
    row = next(line for line in text.splitlines()
               if line.startswith("model.attention"))
    assert row.split()[1:6] == ["2.0", "0.010", "0.010", "0.014", "0.011"]


def _ctx(**extra):
    ops = trace.attribute(EVENTS, train._modules())
    return train.Ctx(host_s=[0.5, 0.6, 0.7], window_s=2.0, window_flops=1e12,
                     chips=1, ops=ops, traced_steps=1,
                     timeline=trace.timeline(EVENTS), lans_bytes=1e6,
                     window_peak_bytes=2 ** 30, **extra)


def test_existing_readers_read_the_same_beside_the_spans():
    from bench.harness import spec
    report = spans.read(EVENTS, 1)
    counts = {"moe.pairs_routed": 4}
    plain = _ctx()
    spanned = _ctx(spans=report, counters=counts)
    want = spans.readings(report, counts)
    read = 0
    for name, mod in spec.all_metric_modules().items():
        a, b = mod.read(plain), mod.read(spanned)
        if name in SPAN_READINGS:      # the span readers read the report
            assert (a, b) == (None, want.get(name)), name
        else:
            assert a == b, name
            read += a is not None
    assert read >= 4


def _devicified(events):
    """Each matmul of a CPU trace as a device op launched where it ran."""
    out, corr = list(events), 10 ** 6
    for e in events:
        if e.get("cat") == "cpu_op" and e["name"] in (
                "aten::mm", "aten::addmm", "aten::bmm"):
            corr += 1
            out.append(ev("cuda_runtime", "cudaLaunchKernel", e["ts"], 0.1,
                          e["tid"], correlation=corr))
            out.append(ev("kernel", "gemm", e["ts"] + 0.2,
                          max(e["dur"] - 0.2, 0.1), STREAM,
                          correlation=corr))
    return out


def test_a_real_cpu_trace_splits_attention_into_its_passes(tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function
    run = train.Run(tiny_job("bert-large.p1-seq128"), 3, torch.device("cpu"))
    run.first_steps()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.STRETCH):
            for _ in range(2):
                run.program.step(run.feed())
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    r = spans.read(_devicified(json.loads(path.read_text())["traceEvents"]),
                   2)
    passes = {ps for (p, ps) in r.device_us if "model.attention" in p}
    assert passes == {F, R, B}
    assert {ps for (p, ps) in r.device_us if "model.head" in p} == {F, B}
    assert sum(r.device_us.values()) == pytest.approx(r.busy_us)
    assert sum(r.idle_us.values()) == pytest.approx(r.idle_total_us)
    assert r.span_counts["train.step"] == 2
    assert r.span_counts["sync.finite_flag"] == 2
    assert set(spans.readings(r, {})) == {
        "attention_ms", "head_ms", "idle_forward_ms", "idle_backward_ms",
        "idle_update_ms", "host_sync_ms"}


def _cpu_record(tmp_path, seen):
    """trace.record on the CPU: each matmul a device op (_devicified);
    keeps each stretch's events and, around the one without stacks, the
    program's counters' change."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.metrics import counters

    def record(torch_, step, steps, with_stack):
        before = counters()
        with profile(activities=[ProfilerActivity.CPU],
                     with_stack=with_stack) as prof:
            with record_function(trace.STRETCH):
                for _ in range(steps):
                    step()
        after = counters()
        path = tmp_path / f"{len(seen)}.json"
        prof.export_chrome_trace(str(path))
        events = _devicified(json.loads(path.read_text())["traceEvents"])
        seen[with_stack] = (events, {k: v - before.get(k, 0)
                                     for k, v in after.items()})
        return events
    return record


@pytest.mark.parametrize("cell", ["bert-large.p1-seq128",
                                  "granite-moe-3b-a800m-16l.pretrain-seq4096"])
def test_a_traced_run_reads_the_spans_of_its_stretch(cell, tmp_path,
                                                     monkeypatch):
    import time
    from bench.harness import spec
    from repro_torch.models import moe
    # the cell's experts on their gathered rows, as at its full size,
    # where the MoE counts its routed and dropped pairs
    monkeypatch.setattr(moe, "DENSE_ROWS", 0)
    seen = {}
    monkeypatch.setattr(trace, "record", _cpu_record(tmp_path, seen))
    job = tiny_job(cell)
    job.per_layer = [m.name for m in spec.cell(cell).per_layer]
    res = train.run(job, 2 ** 31 + 17, 0.2, True,
                    device=torch.device("cpu"),
                    t_start=time.perf_counter())
    events, counts = seen[False]
    want = spans.readings(spans.read(events, train.TRACE_STEPS), counts)
    got = {k: v["value"] for k, v in res["metrics"].items()
           if k in SPAN_READINGS}
    assert got == want
    moe_names = {"moe_route_ms", "moe_experts_ms", "moe_drop_share"}
    assert set(got) == set(SPAN_READINGS) - (
        set() if "granite" in cell else moe_names)
    assert 0 < got.get("moe_drop_share", 1) < 100
