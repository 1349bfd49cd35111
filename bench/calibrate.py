"""Readings that the limits of a training cell are set from (see
limits/<cell>.json and PERF.md): for each seed, the comparison's numbers
of the program's first three steps, of the control (the reference
computed in float8, put in the program's place) and of the faults
planted in the program (train.FAULTS), each against the float32
reference.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--what program,control,half_batch,ffn_fp8] [--only-first 4]

One process runs every seed (set-up is paid once per seed, no window).
With --only-first n, what is named beside "program" is read on the
first n seeds alone. Prints one JSON line a seed and reading, then the
largest program reading and the smallest of the others per number.
"""
import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", default="program,control,half_batch")
    ap.add_argument("--only-first", type=int, default=None)
    args = ap.parse_args(argv)
    import torch
    from bench.harness import check, spec, train
    from bench.reference import common
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    job = train.job_of(spec.cell(args.workload))
    what = args.what.split(",")
    device = torch.device("cuda", 0)
    readings = {w: [] for w in what}
    seeds = [int(s) for s in args.seeds.split(",")]
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        now = [w for w in what if w == "program" or args.only_first is None
               or i < args.only_first]
        sides = {}
        pool_np = None
        for w in now:
            if w == "control":
                continue
            run = train.Run(job, seed, device,
                            None if w == "program" else w)
            sides[w] = run.first_steps()
            pool_np = run.pool_np
            run.free()
        if pool_np is None:
            from bench.harness.traffic import make_pool
            pool_np = make_pool(job.mix, job.conf["vocab_size"], seed)
        ref = train.reference_readings(job, seed, device, pool_np)
        if "control" in now:
            sides["control"] = train.reference_readings(
                job, seed, device, pool_np, common.FP8)
        for w, side in sides.items():
            side["grad_diff"] = train.grad_diffs(side, ref, device)
            del side["grad_vec"]
            nums = check.numbers(side, ref, train.watched(job.conf),
                                 train.dense(job.conf))
            readings[w].append(nums)
            top = lambda g: sorted(g.items(), key=lambda kv: -kv[1])[:4]
            nums["grad_top"] = top(check.gaps(side["grad"], ref["grad"]))
            nums["grad_dir_leaves"] = check.shares(side["grad_diff"],
                                                   ref["grad"])
            nums["change_top"] = top(check.gaps(
                side["change"], ref["change"], check.moved(ref["grad"])))
            print(json.dumps({"seed": seed, "what": w, "numbers": nums,
                              "losses": side["losses"],
                              "ref_losses": ref["losses"]}), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    for w, rs in readings.items():
        agg = max if w == "program" else min
        print(json.dumps({"summary": w, "of": len(rs), **{
            k: agg(r[k]["value"] for r in rs) for k in rs[0]
            if not k.endswith(("_top", "_leaves"))}}))
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
