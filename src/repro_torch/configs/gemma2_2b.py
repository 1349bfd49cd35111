"""gemma2-2b [dense] — 26L d_model=2304 8H (GQA kv=4) d_ff=9216
vocab=256000; local+global alternating attention, logit softcap.
[arXiv:2408.00118]

Superblock of 2: sliding-window(4096) layer then global layer (13 periods).
Soft-capping: 50.0 on attention logits, 30.0 on final logits; pre+post
block RMSNorms; embeddings scaled by sqrt(d_model); GeGLU MLP.
"""
from repro_torch.configs.base import Arch
from repro_torch.models.decoder import DecoderConfig

CONFIG = DecoderConfig(
    name="gemma2-2b",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab=256000,
    sliding_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    post_block_norm=True,
    scale_embeds=True,
    activation="gelu",
    gated_mlp=True,
    superblock=(("attn_local", "mlp"), ("attn", "mlp")),
    max_seq=8192,
)

ARCH = Arch(
    name="gemma2-2b",
    kind="decoder",
    cfg=CONFIG,
    source="arXiv:2408.00118",
    long_context_ok=True,
)
