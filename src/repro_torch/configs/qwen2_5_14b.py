"""qwen2.5-14b [dense] — 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064; GQA with QKV bias.  [hf:Qwen/Qwen2.5-0.5B]"""
from repro_torch.configs.base import Arch
from repro_torch.models.decoder import DecoderConfig

CONFIG = DecoderConfig(
    name="qwen2.5-14b",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1000000.0,
    activation="silu",
    superblock=(("attn", "mlp"),),
    max_seq=32768,
)

ARCH = Arch(
    name="qwen2.5-14b",
    kind="decoder",
    cfg=CONFIG,
    source="hf:Qwen/Qwen2.5-0.5B",
)
