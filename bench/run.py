"""Run one cell of BENCHMARK.json on this machine's card(s) and print one
JSON result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The harness runs cells of one chip. Without a CUDA card the run exits
with code 2 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# top-level module names the run may not hold: JAX and the JAX package
# (`repro`; `repro_torch` is another name)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from bench.harness import spec
    cell = spec.cell(args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from bench.harness import train
    job = train.job_of(cell)
    result = train.run(job, args.seed, args.seconds, bool(args.trace),
                       device=torch.device("cuda", 0), t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: JAX or the JAX package",
              file=sys.stderr)
        return 1
    for k, c in result["check"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
