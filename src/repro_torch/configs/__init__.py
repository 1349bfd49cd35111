"""Architecture registry of the port: every arch of the JAX package's
registry (the ten assigned archs and the paper's bert-large).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.configs.base import (SHAPES, Arch, InputShape,
                                      reduced_decoder)

_MODULES = {
    "grok-1-314b": "grok_1_314b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "qwen2.5-14b": "qwen2_5_14b",
    "qwen2.5-32b": "qwen2_5_32b",
    "chameleon-34b": "chameleon_34b",
    "whisper-large-v3": "whisper_large_v3",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "mamba2-130m": "mamba2_130m",
    "gemma2-2b": "gemma2_2b",
    "bert-large": "bert_large",
}

# the ten assigned archs: what the dry run's --arch all runs
ASSIGNED = [k for k in _MODULES if k != "bert-large"]

# archs of the JAX package that the port does not have yet: none
NOT_PORTED = ()


def get_arch(name: str) -> Arch:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(
        f"repro_torch.configs.{_MODULES[name]}").ARCH


def all_archs() -> Dict[str, Arch]:
    return {name: get_arch(name) for name in _MODULES}


def reduced_arch(name: str) -> Arch:
    """Smoke-test variant: decoders by reduced_decoder (<= 2 periods,
    d_model 256, <= 4 experts, vocab 1k, max_seq 256, fp32 params);
    encdec 2L per stack / 128d / 4H / ff 256 / vocab 512 / 16 frames /
    max_target 64; bert 2L / 128d / 4H / ff 256 / vocab 512 / max_pos
    128. zero3 is cleared, as in the JAX package."""
    arch = get_arch(name)
    if arch.kind == "encdec":
        return dataclasses.replace(arch, cfg=dataclasses.replace(
            arch.cfg, n_layers=2, d_model=128, n_heads=4, d_ff=256,
            vocab=512, n_frames=16, max_target=64), zero3=False)
    if arch.kind == "bert":
        return dataclasses.replace(arch, cfg=dataclasses.replace(
            arch.cfg, n_layers=2, d_model=128, n_heads=4, d_ff=256,
            vocab=512, max_pos=128), zero3=False)
    return dataclasses.replace(arch, cfg=reduced_decoder(arch.cfg),
                               zero3=False)


__all__ = ["SHAPES", "Arch", "InputShape", "ASSIGNED", "NOT_PORTED",
           "all_archs", "get_arch", "reduced_arch", "reduced_decoder"]
