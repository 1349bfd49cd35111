"""qwen2.5-32b [dense] — 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064; GQA with QKV bias; bf16 params (no fp32 master at 32B).
[hf:Qwen/Qwen2.5-0.5B]"""
import torch

from repro_torch.configs.base import Arch
from repro_torch.models.decoder import DecoderConfig

CONFIG = DecoderConfig(
    name="qwen2.5-32b",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1000000.0,
    activation="silu",
    superblock=(("attn", "mlp"),),
    max_seq=32768,
    param_dtype=torch.bfloat16,
)

ARCH = Arch(
    name="qwen2.5-32b",
    kind="decoder",
    cfg=CONFIG,
    source="hf:Qwen/Qwen2.5-0.5B",
    zero1=True,                # ZeRO-1: moments cut over "data"
    train_microbatches=16,
)
