"""Batched serving demo of the PyTorch port: prefill + incremental greedy
decode, as examples/serve_decode.py does with the JAX package.

Runs reduced gemma2-2b (or another decoder) through the port's
ServeEngine and reports tokens/s from `throughput_probe`, which first
runs a shape-identical warm-up batch. Runs on CUDA unless asked for the
CPU:

  PYTHONPATH=src python examples/serve_decode_torch.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch import select_device
from repro_torch.configs import reduced_arch
from repro_torch.serving import Request, ServeEngine, throughput_probe


def main(argv=None, params=None):
    """Serve one batch; returns (stats, requests). `params` replaces the
    seeded init (e.g. the JAX example's, carried over by
    repro_torch.bridge)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--new-tokens", type=int, default=16)
    args = ap.parse_args(argv)
    device = select_device(args.device)

    arch = reduced_arch(args.arch)
    if arch.kind != "decoder":
        raise SystemExit(f"{args.arch} ({arch.kind}) is not a decoder arch")
    if params is None:
        params = arch.init(torch.Generator(device=device).manual_seed(0))
    engine = ServeEngine(arch, params,
                         max_len=args.prompt_len + args.new_tokens)

    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(5, arch.cfg.vocab,
                                        size=args.prompt_len).astype(np.int32),
                    max_new_tokens=args.new_tokens)
            for _ in range(args.batch)]
    stats = throughput_probe(engine, reqs)
    for i, r in enumerate(reqs):
        print(f"req{i}: prompt[:6]={r.prompt[:6].tolist()} "
              f"-> generated={r.generated.tolist()}")
    print({k: round(v, 2) if isinstance(v, float) else v
           for k, v in stats.items()}, f"device={device}")
    print("serve_decode OK")
    return stats, reqs


if __name__ == "__main__":
    main()
