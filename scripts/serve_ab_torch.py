"""Compare the port's serve CLI across source trees on one card.

For each ROOT, in the order given, one process imports ROOT/src's
repro_torch, serves a 2-request warm-up stream and then `--reps` times
the measured stream (chip_smoke.py's phase 3 stream: gemma2-2b at full
width, fp32, K8, 8 requests, prompts up to 64, 32 new tokens, 4 slots,
seed 0), and prints one JSON line per root with each rep's tokens/s,
ITL p50 and decode steps. To compare two commits, unpack the parent
into a gitignored directory and run parent, change, change, parent in
one call:

  git archive HEAD | tar -x -C _tree/parent
  python3 scripts/serve_ab_torch.py _tree/parent . . _tree/parent
"""
import argparse
import json
import os
import subprocess
import sys

SERVE_ARGV = ["--arch", "gemma2-2b", "--full", "--precision", "fp32",
              "--attn-kernel", "paged", "--requests", "8", "--max-batch",
              "4", "--prompt-len", "64", "--new-tokens", "32", "--seed", "0",
              "--device", "cuda"]

CHILD = """
import json, sys
from repro_torch.launch import serve
argv, reps = json.loads(sys.argv[1]), int(sys.argv[2])
warm = list(argv)
warm[warm.index("--requests") + 1] = "2"
warm[warm.index("--new-tokens") + 1] = "4"
serve.main(warm)
runs = []
for _ in range(reps):
    stats, _ = serve.main(argv)
    runs.append({k: stats[k] for k in ("tokens_per_s", "itl_p50_ms",
                                       "itl_p99_ms", "decode_steps")})
print("AB " + json.dumps(runs))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    for root in args.roots:
        root = os.path.abspath(root)
        env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
        out = subprocess.run(
            [sys.executable, "-c", CHILD, json.dumps(SERVE_ARGV),
             str(args.reps)], cwd=root, env=env, capture_output=True,
            text=True, timeout=600)
        if out.returncode:
            sys.stderr.write(out.stderr[-4000:])
            return out.returncode
        runs = json.loads(next(line for line in out.stdout.splitlines()
                               if line.startswith("AB "))[3:])
        print(json.dumps({"root": os.path.relpath(root), "runs": runs}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
