"""Architecture registry of the port: the archs ported so far.

The JAX package's registry names more archs; asking for one that has not
been ported yet raises and says so.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import Arch, reduced_decoder

_MODULES = {
    "grok-1-314b": "grok_1_314b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "qwen2.5-14b": "qwen2_5_14b",
    "qwen2.5-32b": "qwen2_5_32b",
    "chameleon-34b": "chameleon_34b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "mamba2-130m": "mamba2_130m",
    "gemma2-2b": "gemma2_2b",
    "bert-large": "bert_large",
}

# archs of the JAX package that the port does not serve yet
NOT_PORTED = ("whisper-large-v3",)


def get_arch(name: str) -> Arch:
    if name in NOT_PORTED:
        raise NotImplementedError(f"arch {name!r} is not ported yet; "
                                  f"ported: {sorted(_MODULES)}")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(
        f"repro_torch.configs.{_MODULES[name]}").ARCH


def reduced_arch(name: str) -> Arch:
    """Smoke-test variant: decoders by reduced_decoder (<= 2 periods,
    d_model 256, <= 4 experts, vocab 1k, max_seq 256, fp32 params); bert 2L / 128d / 4H / ff 256 / vocab 512 /
    max_pos 128."""
    arch = get_arch(name)
    if arch.kind == "bert":
        return dataclasses.replace(arch, cfg=dataclasses.replace(
            arch.cfg, n_layers=2, d_model=128, n_heads=4, d_ff=256,
            vocab=512, max_pos=128))
    return dataclasses.replace(arch, cfg=reduced_decoder(arch.cfg))


__all__ = ["Arch", "NOT_PORTED", "get_arch", "reduced_arch",
           "reduced_decoder"]
