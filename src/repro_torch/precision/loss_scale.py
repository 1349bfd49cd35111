"""Loss scaling — the apex state machine (port of
repro/precision/loss_scale.py).

fp16 gradients underflow (min normal 6e-5); scaling the loss by S shifts
the gradient distribution into range, and the optimizer divides it back
out in fp32. Any inf/NaN gradient means S was too large: the step is
SKIPPED (params/moments untouched) and S is halved. After
`growth_interval` consecutive good steps S doubles back.

The state is a NamedTuple of 0-d tensors on the parameters' device, and
every decision is a torch.where on them: the scaler itself never reads
a value back to the host.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.optim.base import tree_leaves, tree_map
from repro_torch.distributed.partial import whole


class LossScaleState(NamedTuple):
    scale: torch.Tensor           # fp32 0-d, current multiplier S
    good_steps: torch.Tensor      # int32, consecutive finite steps
    overflow_count: torch.Tensor  # int32, total skipped steps (monotonic)


def all_finite(tree) -> torch.Tensor:
    """0-d bool tensor: every element of every floating leaf is finite (a
    plain tensor, the same on every rank, for DTensor leaves too)."""
    leaves = [l for l in tree_leaves(tree) if l.is_floating_point()]
    if not leaves:
        return torch.ones((), dtype=torch.bool)
    return torch.stack([whole(torch.isfinite(l).all())
                        for l in leaves]).all()


def unscale_grads(grads, state: LossScaleState):
    """grads / S in fp32 (float leaves only) — shared by both scalers."""
    inv = 1.0 / state.scale
    return tree_map(lambda g: g.float() * inv if g.is_floating_point()
                    else g, grads)


def _init(scale_value: float, device) -> LossScaleState:
    return LossScaleState(
        scale=torch.full((), scale_value, dtype=torch.float32,
                         device=device),
        good_steps=torch.zeros((), dtype=torch.int32, device=device),
        overflow_count=torch.zeros((), dtype=torch.int32, device=device))


@dataclasses.dataclass(frozen=True)
class DynamicLossScale:
    """apex.amp dynamic scaling: start high, halve on overflow, double
    after `growth_interval` clean steps (apex's DynamicLossScaler
    defaults: init 2^16, window 2000, x2 growth / x0.5 backoff)."""

    init_scale: float = 2.0 ** 16
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000
    min_scale: float = 1.0
    max_scale: float = 2.0 ** 24

    def init(self, device="cpu") -> LossScaleState:
        return _init(self.init_scale, device)

    unscale = staticmethod(unscale_grads)

    def adjust(self, state: LossScaleState, grads_finite) -> LossScaleState:
        good = state.good_steps + 1
        grow = good >= self.growth_interval
        grown = torch.clamp(state.scale * self.growth_factor,
                            max=self.max_scale)
        scale_ok = torch.where(grow, grown, state.scale)
        good_ok = torch.where(grow, torch.zeros_like(good), good)
        scale_bad = torch.clamp(state.scale * self.backoff_factor,
                                min=self.min_scale)
        return LossScaleState(
            scale=torch.where(grads_finite, scale_ok, scale_bad),
            good_steps=torch.where(grads_finite, good_ok,
                                   torch.zeros_like(good)),
            overflow_count=state.overflow_count
            + (~grads_finite).to(torch.int32))


@dataclasses.dataclass(frozen=True)
class StaticLossScale:
    """Fixed multiplier (1.0 == no scaling, the bf16 case). Overflow
    still skips the step and is counted, but the scale never moves."""

    scale_value: float = 1.0

    def init(self, device="cpu") -> LossScaleState:
        return _init(self.scale_value, device)

    unscale = staticmethod(unscale_grads)

    def adjust(self, state: LossScaleState, grads_finite) -> LossScaleState:
        ok = grads_finite.to(torch.int32)
        return LossScaleState(scale=state.scale,
                              good_steps=state.good_steps + ok,
                              overflow_count=state.overflow_count + 1 - ok)
