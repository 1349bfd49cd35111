"""chameleon-34b [vlm] — 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536; early fusion with VQ image tokens; QK-norm; bf16 params.
[arXiv:2405.09818]

Early fusion puts the VQ image tokens in the text vocabulary, so the
backbone is a dense decoder over token ids. The image tokenizer is a
stub: training batches may carry precomputed (B, S, d_model) input
embeddings (embeds_input=True), the sequence its projector would emit.
"""
import torch

from repro_torch.configs.base import Arch
from repro_torch.models.decoder import DecoderConfig

CONFIG = DecoderConfig(
    name="chameleon-34b",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab=65536,
    qk_norm=True,
    activation="silu",
    superblock=(("attn", "mlp"),),
    max_seq=8192,
    param_dtype=torch.bfloat16,
)

ARCH = Arch(
    name="chameleon-34b",
    kind="decoder",
    cfg=CONFIG,
    source="arXiv:2405.09818",
    zero1=True,                # ZeRO-1: moments cut over "data"
    train_microbatches=16,
    embeds_input=True,
)
