"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16 experts top-2; Mamba:attention 7:1
interleave with MoE every other layer.  [arXiv:2403.19887]

Superblock of 8 (72 = 9 periods): attention at slot 0, Mamba at slots
1-7; MoE ffn on odd slots, dense ffn on even ones. Jamba uses Mamba-1
selective-scan blocks; this package implements the Mamba-2 SSD chunked
form of the same selective state-space computation, as the JAX package
does. bf16 params at full size; the full config is shape metadata here
(it does not fit one card), the reduced one runs.
"""
import torch

from repro_torch.configs.base import Arch
from repro_torch.models.decoder import DecoderConfig

_PERIOD = (
    ("attn", "mlp"),
    ("mamba", "moe"),
    ("mamba", "mlp"),
    ("mamba", "moe"),
    ("mamba", "mlp"),
    ("mamba", "moe"),
    ("mamba", "mlp"),
    ("mamba", "moe"),
)

CONFIG = DecoderConfig(
    name="jamba-1.5-large-398b",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab=65536,
    n_experts=16,
    top_k=2,
    activation="silu",
    mamba_d_inner=16384,
    mamba_headdim=128,
    mamba_dstate=128,
    mamba_chunk=64,
    superblock=_PERIOD,
    max_seq=262144,
    param_dtype=torch.bfloat16,
)

ARCH = Arch(
    name="jamba-1.5-large-398b",
    kind="decoder",
    cfg=CONFIG,
    source="arXiv:2403.19887",
    zero3=True,
    train_microbatches=8,
    long_context_ok=True,      # Mamba slots O(1) per token; 1-in-8 attn
)
