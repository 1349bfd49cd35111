"""The program's own spans in one cell's traced stretch (harness/spans.py):
the table by span on stderr, then one JSON line with the span readings,
the program's counters a step and the frame-based readings they refine.

    python3 bench/span_table.py --workload <cell> --seed <n>

Set-up is a run's (train.Run: the program built and its first three
steps); then a stretch of train.TRACE_STEPS steps traced without Python
stacks, the program's counters read around it (Run.counted_stretch, as
a traced run of bench/run.py reads them), and one with stacks for the
frame-based readings (attention_fwd_ms, moe_fwd_ms, fwd_bwd_ms,
lans_update_ms). No window and no reference: nothing here is compared.
Needs a CUDA card (exit code 2 without one).
"""
import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

FRAME_READINGS = ("attention_fwd_ms", "moe_fwd_ms", "fwd_bwd_ms",
                  "lans_update_ms")


def traced(run, steps: int):
    """(no-stack events, the program's counters' change over them, a
    Ctx of the stacked stretch for the frame-based readers)."""
    from bench.harness import train, trace
    events, delta = run.counted_stretch()
    ops = trace.attribute(run.stretch(with_stack=True), train._modules())
    ctx = train.Ctx(ops=ops, traced_steps=steps, timeline=None)
    return events, delta, ctx


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    from bench.harness import spans, spec, train
    job = train.job_of(spec.cell(args.workload))
    run = train.Run(job, args.seed, torch.device("cuda", 0))
    run.first_steps()
    events, delta, ctx = traced(run, train.TRACE_STEPS)
    report = spans.read(events, train.TRACE_STEPS)
    print(spans.table(report), file=sys.stderr)
    frames = {}
    for name in FRAME_READINGS:
        v = spec.metric_module(name).read(ctx)
        if v is not None:
            frames[name] = v
    n = train.TRACE_STEPS
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "device": torch.cuda.get_device_name(0),
        "spans": spans.readings(report, delta),
        "counters_per_step": {k: v / n for k, v in sorted(delta.items())},
        "frames": frames,
        "busy_ms": report.busy_us / 1e3, "idle_ms":
            report.idle_total_us / 1e3,
        "device_by_span_ms": sum(report.device_us.values()) / 1e3,
        "idle_by_span_ms": sum(report.idle_us.values()) / 1e3}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
