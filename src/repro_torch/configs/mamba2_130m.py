"""mamba2-130m [ssm] — 24L d_model=768 (attention-free) vocab=50280,
ssm_state=128; SSD (state-space duality).  [arXiv:2405.21060]

Pure SSM: mixer-only blocks (d_ff=0; ffn slot "none"). n_heads and
n_kv_heads are unused (no attention) and kept for the config's plumbing.
"""
from repro_torch.configs.base import Arch
from repro_torch.models.decoder import DecoderConfig

CONFIG = DecoderConfig(
    name="mamba2-130m",
    n_layers=24,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=0,
    vocab=50280,
    mamba_d_inner=1536,
    mamba_headdim=64,
    mamba_dstate=128,
    mamba_chunk=64,
    tie_embeddings=True,
    superblock=(("mamba", "none"),),
    max_seq=1048576,
)

ARCH = Arch(
    name="mamba2-130m",
    kind="decoder",
    cfg=CONFIG,
    source="arXiv:2405.21060",
    long_context_ok=True,      # O(1) state per token
)
