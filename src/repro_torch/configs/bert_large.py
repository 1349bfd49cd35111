"""bert-large — the paper's own pretraining workload (Devlin et al. 2019).

24L / 1024d / 16H / ff 4096 / vocab 30522. Trained with LANS at batch
96K (phase 1, seq 128) and 33K (phase 2, seq 512) in the paper.
"""
from repro_torch.configs.base import Arch
from repro_torch.models.bert import BertConfig

CONFIG = BertConfig(
    name="bert-large",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    d_ff=4096,
    vocab=30522,
    max_pos=512,
)

ARCH = Arch(
    name="bert-large",
    kind="bert",
    cfg=CONFIG,
    source="arXiv:1810.04805 / LANS paper §4",
)
