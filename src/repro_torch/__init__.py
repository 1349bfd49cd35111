"""PyTorch/CUDA port of the `repro` package (which stays the reference).

The port keeps repro's module names (`repro_torch/models/attention.py`
mirrors `repro/models/attention.py`, and so on) and imports neither JAX
nor `repro`. Each hand-written Hopper kernel sits beside its plain
PyTorch version under `kernels/`. Entry points run on CUDA unless the
caller asks for the CPU (`select_device`).
"""
from __future__ import annotations

import torch


def select_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless `device` asks for
    the CPU. Raises when CUDA is asked for (or defaulted to) and there is
    no GPU — nothing falls back quietly. Also turns TF32 off for matmuls
    and convolutions: parity with the reference is fp32 parity."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "--device cpu (device='cpu') to run on the CPU")
    return dev
