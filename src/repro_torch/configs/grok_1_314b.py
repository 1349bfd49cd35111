"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2.  [hf:xai-org/grok-1]

bf16 params at full size; the full config is shape metadata here (it
does not fit one card), the reduced one runs.
"""
import torch

from repro_torch.configs.base import Arch
from repro_torch.models.decoder import DecoderConfig

CONFIG = DecoderConfig(
    name="grok-1-314b",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab=131072,
    n_experts=8,
    top_k=2,
    activation="gelu",
    gated_mlp=True,
    superblock=(("attn", "moe"),),
    max_seq=8192,
    param_dtype=torch.bfloat16,
)

ARCH = Arch(
    name="grok-1-314b",
    kind="decoder",
    cfg=CONFIG,
    source="hf:xai-org/grok-1",
    zero3=True,                # FSDP over the data axis (314B params)
    train_microbatches=8,
    long_context_ok=False,     # full attention, no windowed variant
)
