"""Optimizers of the port (port of repro/core/optim). LANS, unfused and
fused, is ported; LAMB and AdamW come with the next slice."""
from repro_torch.core.optim.base import (
    GradientTransformation,
    WeightDecayMask,
    apply_updates,
    chain,
    scale_by_schedule,
    tree_paths,
)
from repro_torch.core.optim.fused import FusedState, fused_lamb, fused_lans
from repro_torch.core.optim.lans import LansState, lans, scale_by_lans

__all__ = [
    "GradientTransformation", "WeightDecayMask", "apply_updates", "chain",
    "scale_by_schedule", "tree_paths",
    "FusedState", "fused_lamb", "fused_lans",
    "LansState", "lans", "scale_by_lans",
]
