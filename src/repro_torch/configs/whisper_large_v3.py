"""whisper-large-v3 [audio]: encoder-decoder, 32 layers per stack,
d_model 1280, 20 heads (MHA), d_ff 5120, vocab 51866; the conv/mel
frontend is a stub. [arXiv:2212.04356]

The model takes precomputed frame embeddings (B, 1500, 1280) in place of
the mel-spectrogram and conv feature extractor. max_target is 32768,
past the model card's 448 tokens, so that long decode shapes stress the
decoder backbone (positions past it read the table's last row).
"""
from repro_torch.configs.base import Arch
from repro_torch.models.encdec import EncDecConfig

CONFIG = EncDecConfig(
    name="whisper-large-v3",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    d_ff=5120,
    vocab=51866,
    n_frames=1500,
    max_target=32768,
)

ARCH = Arch(
    name="whisper-large-v3",
    kind="encdec",
    cfg=CONFIG,
    source="arXiv:2212.04356",
)
