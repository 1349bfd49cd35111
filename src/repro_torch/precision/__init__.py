"""Mixed precision of the port (port of repro/precision): policies with
fp32 overrides for norms and biases, apex-style loss scaling
(dynamic skip-and-halve / static), fp32 master weights as a wrapper
around any optimizer, and the fused cast-and-apply LANS path (K4).

    policy = get_policy("fp16_mixed")
    tx = mixed_precision(lans(sched, mu_dtype=policy.moment_dtype), policy)
    params = policy.cast_params(arch.init(gen))
    state = tx.init(params)
"""
from repro_torch.precision.fused import FusedMixedState, fused_mixed_lans
from repro_torch.precision.loss_scale import (
    DynamicLossScale,
    LossScaleState,
    StaticLossScale,
    all_finite,
)
from repro_torch.precision.mixed import (
    MixedPrecisionState,
    MixedTransformation,
    find_loss_scale,
    loss_scale_value,
    mixed_precision,
    overflow_count,
)
from repro_torch.precision.policy import (KEEP_FP32, Policy, get_policy,
                                          tree_cast)

__all__ = [
    "DynamicLossScale", "FusedMixedState", "KEEP_FP32", "LossScaleState",
    "MixedPrecisionState", "MixedTransformation", "Policy",
    "StaticLossScale", "all_finite",
    "find_loss_scale", "fused_mixed_lans", "get_policy", "loss_scale_value",
    "mixed_precision", "overflow_count", "tree_cast",
]
