"""Training launcher of the port (port of repro/launch/train.py).

Trains bert-large, a decoder (gemma2-2b, qwen2.5-14b/32b,
mistral-nemo-12b, chameleon-34b; the MoE granite-moe-3b-a800m and
grok-1-314b, whose aux load-balance loss is added with weight 0.01; the
Mamba-2 mamba2-130m and the hybrid jamba-1.5-large-398b, whose --seq
must be a multiple of the SSD chunk) or the encoder-decoder
whisper-large-v3 (reduced by default, `--full` for the real widths and
depth) with the paper's recipe: LANS + warmup-hold-decay schedule +
sharded-without-replacement data (masked-LM batches for BERT, next-token
batches for the decoders, with random input embeddings for chameleon's
stubbed image tokenizer, and for whisper with random frame embeddings in
place of its stubbed audio frontend). Same flags as the JAX launcher,
plus `--device` (CUDA unless `--device cpu`; it raises without a GPU):

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch bert-large --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch qwen2.5-14b --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch whisper-large-v3 --steps 3

Mixed precision (--precision {fp32,bf16,fp16}): bf16/fp16 hold the model
copy in half precision with fp32 master weights in the optimizer state;
fp16 adds dynamic loss scaling (skip the step and halve the scale on
overflow). `loss_scale` and `overflow_count` appear in the console line
and the JSONL metrics. Each JSONL line also carries the step's change of
the port's counters (metrics/spans.py): `sync.finite_flag` and
`sync.moe_counts` (the step's reads of the device), `moe.pairs_routed`,
`moe.pairs_dropped` and `optim.skipped_steps`.
`--optimizer {lans,lamb,adamw}` picks the unfused transform, as the JAX
launcher does (only lans stores its moments in the policy's moment
dtype; under bf16/fp16 every optimizer goes through the generic
`mixed_precision` wrapper). The fused kernels are reached
through the library: `build_train_step(..., fused_lans(...))` or
`fused_lamb(...)`.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch import precision as prec
from repro_torch import select_device
from repro_torch.checkpoint import save as ckpt_save
from repro_torch.configs import get_arch, reduced_arch
from repro_torch.core.optim import adamw, lamb, lans
from repro_torch.core.schedules import (constant, warmup_hold_decay,
                                        warmup_linear_decay)
from repro_torch.data.corpus import (SyntheticCorpus, lm_batch_iterator,
                                     mlm_batch_iterator)
from repro_torch.data.sharding import ShardSpec
from repro_torch.distributed.steps import build_train_step
from repro_torch.metrics import MetricsLogger, counters

# the port's counters (metrics/spans.py) whose change over each step the
# JSONL line carries
LOGGED_COUNTERS = ("sync.finite_flag", "sync.moe_counts", "moe.pairs_routed",
                   "moe.pairs_dropped", "optim.skipped_steps")


def make_optimizer(name: str, schedule, *, policy=None, **kw):
    if name == "lans" and policy is not None:
        # moments store in the policy's dtype (math stays fp32)
        kw.setdefault("mu_dtype", policy.moment_dtype)
    return {"lans": lans, "lamb": lamb, "adamw": adamw}[name](schedule, **kw)


def make_data(arch, *, batch: int, seq: int, num_workers: int = 1,
              seed: int = 0):
    """Sharded-without-replacement stream (paper §3.4), worker 0 view;
    numpy batches: masked-LM batches for bert, next-token batches for the
    decoders, for an embeds_input arch (fp32 N(0, 0.02^2) embeddings
    from a numpy generator seeded `seed`, labels), and for encdec
    (N(0, 1) frames (batch, n_frames, d_model) from that generator, one
    draw per batch, tokens, labels), as the JAX launcher makes them."""
    corpus = SyntheticCorpus(vocab=arch.cfg.vocab, num_docs=4096,
                             doc_len=max(2 * seq + 2, 256), seed=seed)
    spec = ShardSpec(num_samples=corpus.num_docs, num_workers=num_workers,
                     worker=0, seed=seed)
    if arch.kind == "bert":
        return mlm_batch_iterator(corpus, spec, per_worker_batch=batch,
                                  seq_len=seq, seed=seed)
    lm = lm_batch_iterator(corpus, spec, per_worker_batch=batch,
                           seq_len=seq)
    if arch.kind == "encdec":
        rng = np.random.default_rng(seed)
        return ({"frames": rng.normal(
                    size=(batch, arch.cfg.n_frames, arch.cfg.d_model)
                 ).astype(np.float32),
                 "tokens": b["tokens"], "labels": b["labels"]} for b in lm)
    if not arch.embeds_input:
        return lm
    rng = np.random.default_rng(seed)
    return ({"embeds": rng.normal(size=(batch, seq, arch.cfg.d_model)
                                  ).astype(np.float32) * 0.02,
             "labels": b["labels"]} for b in lm)


def make_schedule(kind: str, lr: float, steps: int, warmup_frac: float,
                  hold_frac: float):
    warm = max(1, int(steps * warmup_frac))
    hold = int(steps * hold_frac)
    if kind == "hold":
        return warmup_hold_decay(lr, steps + 1, warm, hold)
    if kind == "linear":
        return warmup_linear_decay(lr, steps + 1, warm)
    return constant(lr)


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="bert-large")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--optimizer", default="lans",
                    choices=["lans", "lamb", "adamw"])
    ap.add_argument("--precision", default="fp32",
                    choices=["fp32", "bf16", "fp16"],
                    help="fp16/bf16: low-precision model copy + fp32 master "
                         "weights; fp16 adds dynamic loss scaling")
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--schedule", default="hold",
                    choices=["hold", "linear", "const"])
    ap.add_argument("--warmup-frac", type=float, default=0.2)
    ap.add_argument("--hold-frac", type=float, default=0.3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--metrics", default="", help="JSONL metrics path")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None):
    """Parse `argv` (default: sys.argv), train, print the JAX launcher's
    last JSON line. Returns the summary: first/final loss, steps, the
    per-step losses and seconds, the mean step seconds after the first
    step, and, for mixed precision, the final loss_scale and
    overflow_count."""
    args = build_parser().parse_args(argv)
    arch = reduced_arch(args.arch) if args.reduced else get_arch(args.arch)
    if args.reduced:
        args.seq = min(args.seq, arch.cfg.max_pos if arch.kind == "bert"
                       else getattr(arch.cfg, "max_seq", args.seq))
    sched = make_schedule(args.schedule, args.lr, args.steps,
                          args.warmup_frac, args.hold_frac)
    policy = prec.get_policy(args.precision)
    tx = make_optimizer(args.optimizer, sched, policy=policy)
    data = make_data(arch, batch=args.batch, seq=args.seq, seed=args.seed)
    if policy.wants_wrapper:
        arch = dataclasses.replace(arch, cfg=policy.apply_to_cfg(arch.cfg))

    device = select_device(args.device)
    step_fn, init_fn = build_train_step(arch.loss_fn, tx,
                                        param_init_fn=arch.init,
                                        policy=policy)
    params, opt_state = init_fn(
        torch.Generator(device=device).manual_seed(args.seed))

    losses, step_s = [], []
    logger = MetricsLogger(args.metrics or None)
    t0 = time.perf_counter()
    extra = {}
    for i in range(args.steps):
        t_step = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in next(data).items()}
        before = counters()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        after = counters()
        losses.append(float(metrics["loss"]))     # waits for the step
        step_s.append(time.perf_counter() - t_step)
        if policy.wants_wrapper:
            extra = {"loss_scale": float(metrics["loss_scale"]),
                     "overflow_count": int(metrics["overflow_count"])}
        lr = float(sched(i))
        logger.log(i + 1, loss=losses[-1], lr=lr, **extra,
                   **{k: after.get(k, 0) - before.get(k, 0)
                      for k in LOGGED_COUNTERS})
        if (i + 1) % args.log_every == 0 or i == 0:
            ls_txt = (f"  scale {extra['loss_scale']:.0f}"
                      f"  ovf {extra['overflow_count']}" if extra else "")
            print(f"step {i + 1:5d}  loss {losses[-1]:.4f}  "
                  f"(ema {logger.smoothed_loss:.4f})  lr {lr:.2e}  "
                  f"{(time.perf_counter() - t0) / (i + 1):.2f}s/step{ls_txt}",
                  flush=True)
    logger.close()

    if args.ckpt_dir:
        ckpt_save(args.ckpt_dir, args.steps, params,
                  metadata={"arch": args.arch, "optimizer": args.optimizer,
                            "final_loss": losses[-1]})
        print("checkpoint saved to", args.ckpt_dir)
    print(json.dumps({"first_loss": losses[0], "final_loss": losses[-1],
                      "steps": args.steps}))
    later = step_s[1:] or step_s
    return {"first_loss": losses[0], "final_loss": losses[-1],
            "steps": args.steps, "losses": losses, "step_s": step_s,
            "mean_step_s": sum(later) / len(later), "device": str(device),
            "precision": args.precision, **extra}


if __name__ == "__main__":
    main()
