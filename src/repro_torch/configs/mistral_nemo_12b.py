"""mistral-nemo-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072; 128k native context.  [hf:mistralai/Mistral-Nemo-Base-2407]

Every layer is an "attn_local" slot with a sliding window of 131072 (the
model's native context), so a serving ring stays bounded; for shorter
sequences the window exceeds the sequence and the layer is full
attention.
"""
from repro_torch.configs.base import Arch
from repro_torch.models.decoder import DecoderConfig

CONFIG = DecoderConfig(
    name="mistral-nemo-12b",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    rope_theta=1000000.0,
    sliding_window=131072,
    activation="silu",
    superblock=(("attn_local", "mlp"),),
    max_seq=131072,
)

ARCH = Arch(
    name="mistral-nemo-12b",
    kind="decoder",
    cfg=CONFIG,
    source="hf:mistralai/Mistral-Nemo-Base-2407",
    long_context_ok=True,
)
