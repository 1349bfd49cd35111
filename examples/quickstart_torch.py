"""Quickstart of the PyTorch port: the paper's recipe in ~40 lines.

LANS optimizer + warmup-hold-decay schedule + sharded-without-replacement
data, training a small causal LM (reduced qwen2.5-14b), as
examples/quickstart.py does with the JAX package. Runs on CUDA unless
asked for the CPU:

  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

import torch

from repro_torch import select_device
from repro_torch.configs import reduced_arch
from repro_torch.core.optim import apply_updates, lans
from repro_torch.core.schedules import warmup_hold_decay
from repro_torch.data.corpus import SyntheticCorpus, lm_batch_iterator
from repro_torch.data.sharding import ShardSpec
from repro_torch.distributed.steps import loss_and_grads

STEPS, BATCH, SEQ = 30, 8, 64


def main(argv=None, params=None):
    """Train; returns the per-step losses. `params` replaces the seeded
    init (e.g. the JAX quickstart's, carried over by repro_torch.bridge)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    device = select_device(args.device)

    # 1. a model from the architecture zoo (reduced for a quick run)
    arch = reduced_arch("qwen2.5-14b")
    if params is None:
        params = arch.init(torch.Generator(device=device).manual_seed(0))

    # 2. the paper's optimizer (Algorithm 2) + LR schedule (eq. 9)
    schedule = warmup_hold_decay(eta=3e-3, total_steps=STEPS + 1,
                                 warmup_steps=6, hold_steps=10)
    tx = lans(schedule)
    opt_state = tx.init(params)

    # 3. the paper's data sharding (§3.4): this process is worker 0 of 4
    corpus = SyntheticCorpus(vocab=arch.cfg.vocab, num_docs=1024,
                             doc_len=256)
    shard = ShardSpec(num_samples=1024, num_workers=4, worker=0)
    data = lm_batch_iterator(corpus, shard, per_worker_batch=BATCH,
                             seq_len=SEQ)

    def train_step(params, opt_state, batch):
        # loss and fp32 gradients of arch.loss_fn (no loss scale)
        loss, _, grads = loss_and_grads(arch.loss_fn, params, batch, None)
        with torch.no_grad():
            updates, opt_state = tx.update(grads, opt_state, params)
            return apply_updates(params, updates), opt_state, loss

    losses = []
    for step in range(args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in next(data).items()}
        params, opt_state, loss = train_step(params, opt_state, batch)
        losses.append(float(loss))
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:3d}  loss {losses[-1]:.4f}  "
                  f"lr {float(schedule(step)):.2e}")
    print("quickstart OK")
    return losses


if __name__ == "__main__":
    main()
