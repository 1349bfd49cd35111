"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40 experts top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from repro_torch.configs.base import Arch
from repro_torch.models.decoder import DecoderConfig

CONFIG = DecoderConfig(
    name="granite-moe-3b-a800m",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab=49155,
    n_experts=40,
    top_k=8,
    activation="silu",
    gated_mlp=True,
    superblock=(("attn", "moe"),),
    max_seq=8192,
)

ARCH = Arch(
    name="granite-moe-3b-a800m",
    kind="decoder",
    cfg=CONFIG,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
