"""Optimizers of the port (port of repro/core/optim): LANS and LAMB,
unfused and fused on the hand-written kernels, AdamW / BN-AdamW and SGD."""
from repro_torch.core.optim.base import (
    GradientTransformation,
    WeightDecayMask,
    apply_updates,
    chain,
    identity,
    scale,
    scale_by_schedule,
    tree_paths,
)
from repro_torch.core.optim.adamw import adamw, bn_adamw, scale_by_adamw, sgd
from repro_torch.core.optim.fused import FusedState, fused_lamb, fused_lans
from repro_torch.core.optim.lamb import LambState, lamb, scale_by_lamb
from repro_torch.core.optim.lans import LansState, lans, scale_by_lans

__all__ = [
    "GradientTransformation", "WeightDecayMask", "apply_updates", "chain",
    "identity", "scale", "scale_by_schedule", "tree_paths",
    "adamw", "bn_adamw", "scale_by_adamw", "sgd",
    "FusedState", "fused_lamb", "fused_lans",
    "LambState", "lamb", "scale_by_lamb",
    "LansState", "lans", "scale_by_lans",
]
