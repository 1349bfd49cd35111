#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one GPU.

  python3 chip_smoke.py      # needs one CUDA card

Phases, each of which fails the run:
  1. build every kernel under src/repro_torch/kernels/csrc (one nvcc per
     source, all started together) and print the build time;
  2. hold each kernel against its plain PyTorch version on the card at
     gemma2-2b's attention shapes (fp32 and bf16 arenas, S = 1 and 4, a
     dead slot, position -1 rows, window on and off, softcap on, with and
     without a new row routed to a null table entry): outputs
     within 1e-5 (fp32 summation order), arenas torch.equal; then time
     kernel and plain version at the shapes the serving run gives it,
     with the L2 cache flushed before each launch, and compute the bound;
  3. serve gemma2-2b at full width and depth through the port's CLI
     (`repro_torch.launch.serve.main`), fp32, with the kernel, then the
     same stream with the plain-torch gather: greedy tokens must be
     equal and the kernel must have launched decode steps x 26 times;
  4. serve once in bf16 with the kernel: it must finish with finite
     logits.

The last lines are the card's name and power limit (nvidia-smi), one
JSON line describing every kernel, and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device, or without the repository beside this script, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12             # fp32 outside the tensor cores
TOL = dict(rtol=1e-5, atol=1e-5)
SERVE_ARGV = ["--arch", "gemma2-2b", "--full", "--precision", "fp32",
              "--attn-kernel", "paged", "--requests", "8", "--max-batch",
              "4", "--prompt-len", "64", "--new-tokens", "32", "--seed", "0"]


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, flush, n=30, warmup=3):
    """Mean device time of fn() over n launches, each after an L2 flush
    (the serving loop reaches a layer's arena after streaming the whole
    model's weights, so it finds it cold)."""
    import torch
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(n):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / n


def paged_bound(args, S):
    """(bound ms, bound_by, bytes, flops) of one paged_attention_fused
    call on these inputs: each referenced non-null block's K, V and
    positions read once, q / new rows / tables / cursors read once, the
    output and the written rows stored once; 4 flops per (query row,
    key, head dim) for QK^T and PV."""
    q, k_new, v_new, k_arena, v_arena, pos, tables, q_pos, cursor = args
    _, bs, n_kv, hd = k_arena.shape
    esz = k_arena.element_size()
    blocks = tables[tables != 0].unique().numel()
    n_new = int((q_pos >= 0).sum())
    nbytes = (blocks * (2 * bs * n_kv * hd * esz + bs * 4)
              + q.numel() * q.element_size() + 2 * k_new.numel() * esz
              + 4 * (tables.numel() + q_pos.numel() + cursor.numel())
              + q.numel() * 4 + n_new * (2 * n_kv * hd * esz + 4))
    keys = int((tables != 0).sum(dim=1).sum()) * bs + S * tables.shape[0]
    flops = 4 * q.shape[2] * hd * S * keys
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, flops


def phase_kernels(torch, pa):
    """Phase 2: parity cases, then timing at the serving shapes. The
    kernel's entry lacks `launches` until the main path has run."""
    max_err = 0.0
    n_cases = 0
    for kv_dt, q_dt in ((torch.float32, torch.float32),
                        (torch.bfloat16, torch.float32),
                        (torch.bfloat16, torch.bfloat16)):
        for S in (1, 4):
            for window, null_write in itertools.product((None, 24),
                                                        (False, True)):
                args = pa.decode_case(B=4, S=S, n_heads=8, n_kv=4,
                                      head_dim=256, block_size=16, nb=8,
                                      dtype=kv_dt, q_dtype=q_dt,
                                      device="cuda", seed=n_cases,
                                      null_write=null_write)
                plain = [a.clone() for a in args]
                kw = dict(scale=256 ** -0.5, window=window, softcap=50.0)
                out = pa.paged_attention_fused(*args, **kw)
                want = pa.paged_attention_fused_plain(*plain, **kw)
                torch.cuda.synchronize()
                err = (out - want).abs().max().item()
                max_err = max(max_err, err)
                torch.testing.assert_close(out, want, **TOL)
                for name, got, ref in zip(("k", "v", "pos"), args[3:6],
                                          plain[3:6]):
                    check(torch.equal(got, ref),
                          f"{name} arena differs from the plain version "
                          f"({kv_dt}, S={S}, window={window}, "
                          f"null_write={null_write})")
                check(bool((out[-1] == 0).all()), "dead slot is not 0")
                n_cases += 1
    print(f"kernel parity: paged_attention_fused, {n_cases} cases, "
          f"max |out - plain| = {max_err:.3e} (tolerance 1e-5), arenas "
          f"torch.equal")

    # the serving run's shapes: 4 slots, S=1, ring 96 rows = 6 blocks of
    # 16, bf16 arenas (the pool's storage dtype), fp32 queries (fp32
    # policy), window 4096 on local layers and softcap 50
    args = pa.decode_case(B=4, S=1, n_heads=8, n_kv=4, head_dim=256,
                          block_size=16, nb=6, dtype=torch.bfloat16,
                          q_dtype=torch.float32, device="cuda", seed=99)
    plain = [a.clone() for a in args]
    kw = dict(scale=256 ** -0.5, window=4096, softcap=50.0)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    ms = time_ms(lambda: pa.paged_attention_fused(*args, **kw), flush)
    plain_ms = time_ms(lambda: pa.paged_attention_fused_plain(*plain, **kw),
                       flush)
    bound_ms, bound_by, nbytes, flops = paged_bound(args, 1)
    print(f"kernel timing (B=4 S=1 h=8 n_kv=4 hd=256 bs=16 nb=6, bf16 "
          f"arenas, L2 flushed): kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, bound {bound_ms:.6f} ms by {bound_by} ({nbytes} bytes at "
          f"3.35 TB/s, {flops} flops at 67 TFLOP/s fp32)")
    return dict(name="paged_attention_fused", route="cuda",
                source="src/repro_torch/kernels/csrc/paged_attention.cu",
                replaces="src/repro/kernels/paged_attention_kernel.py:527",
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                arenas_equal=True)


def serve(serve_mod, argv, label):
    stats, done = serve_mod.main(argv)
    tokens = {r.rid: r.generated.tolist() for r in done}
    print(f"serve[{label}]: requests={stats['requests']} "
          f"tokens={stats['tokens']} decode_steps={stats['decode_steps']} "
          f"tokens_per_s={stats['tokens_per_s']:.2f} "
          f"ttft_p50_ms={stats['ttft_p50_ms']:.2f} "
          f"ttft_p99_ms={stats['ttft_p99_ms']:.2f} "
          f"itl_p50_ms={stats['itl_p50_ms']:.2f} "
          f"itl_p99_ms={stats['itl_p99_ms']:.2f} "
          f"wall_s={stats['wall_s']:.2f}")
    check(stats["requests"] == 8 and stats["tokens"] > 0,
          f"{label}: served {stats['requests']} requests")
    check(stats["nonfinite_logit_steps"] == 0,
          f"{label}: {stats['nonfinite_logit_steps']} steps had NaN/inf "
          f"logits")
    return stats, tokens


def run() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: {src}/repro_torch not found beside this script",
              file=sys.stderr)
        return 3
    sys.path.insert(0, src)
    from repro_torch import select_device
    from repro_torch.kernels import build
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch import serve as serve_mod

    select_device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"build: {len(libs)} kernel libraries ({', '.join(libs)}) in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in libs:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{name}]: {line.strip()}")

    kernel = phase_kernels(torch, pa)

    pa.paged_attention_fused.launches = 0
    paged, paged_tokens = serve(serve_mod, SERVE_ARGV, "fp32 paged")
    kernel["launches"] = pa.paged_attention_fused.launches
    n_layers = 26
    check(kernel["launches"] == paged["decode_steps"] * n_layers,
          f"kernel launched {kernel['launches']} times for "
          f"{paged['decode_steps']} decode steps x {n_layers} layers")
    xla_argv = list(SERVE_ARGV)
    xla_argv[xla_argv.index("paged")] = "xla"
    before = pa.paged_attention_fused.launches
    _, xla_tokens = serve(serve_mod, xla_argv, "fp32 xla")
    check(pa.paged_attention_fused.launches == before,
          "the xla path launched the kernel")
    check(paged_tokens == xla_tokens,
          "greedy tokens differ between --attn-kernel paged and xla")
    print(f"serve: paged == xla greedy tokens for {len(paged_tokens)} "
          f"requests; kernel launches {kernel['launches']} = "
          f"{paged['decode_steps']} decode steps x {n_layers}")
    bf16_argv = list(SERVE_ARGV)
    bf16_argv[bf16_argv.index("fp32")] = "bf16"
    serve(serve_mod, bf16_argv, "bf16 paged")

    print(card_line())
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    try:
        return run()
    except Exception:              # report the failure, exit non-zero
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
