"""Learning-rate schedules from the paper (port of repro/core/schedules.py).

eq. (8): LAMB's linear warmup -> linear decay.
eq. (9): the paper's contribution — linear warmup -> CONSTANT HOLD -> linear
decay. The hold phase lets training spend longer at the (Lipschitz-bounded)
maximum learning rate when eta can no longer scale with sqrt(batch).

A schedule maps the 0-indexed step count (a 0-d integer tensor, or an
int) to a 0-d fp32 tensor on the count's device, so eta never leaves the
card during training. It is elementwise, so an (n,) tensor of counts
gives n learning rates.

Also includes sqrt_scaling_rule, schedule_auc (the Fig. 1 area under the
schedule) and paper_stage_schedules() (the Table 1 hyper-parameters).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]


def _t(count) -> torch.Tensor:
    """1-indexed step as fp32."""
    return torch.as_tensor(count).to(torch.float32) + 1.0


def warmup_linear_decay(eta: float, total_steps: int,
                        warmup_steps: int) -> Schedule:
    """eq. (8). count is the 0-indexed step count (shifted to 1-indexed)."""
    if not 0 < warmup_steps < total_steps:
        raise ValueError(f"need 0 < warmup({warmup_steps}) < total({total_steps})")

    def sched(count):
        t = _t(count)
        warm = eta * t / warmup_steps
        decay = eta * (total_steps - t) / (total_steps - warmup_steps)
        return torch.clamp(torch.where(t <= warmup_steps, warm, decay),
                           min=0.0)

    return sched


def warmup_hold_decay(eta: float, total_steps: int, warmup_steps: int,
                      hold_steps: int) -> Schedule:
    """eq. (9): warmup -> constant hold of ``hold_steps`` -> linear decay."""
    if not 0 < warmup_steps < total_steps:
        raise ValueError(f"need 0 < warmup({warmup_steps}) < total({total_steps})")
    if warmup_steps + hold_steps >= total_steps:
        raise ValueError("warmup + hold must leave room for decay")

    def sched(count):
        t = _t(count)
        warm = eta * t / warmup_steps
        decay = eta * (total_steps - t) / (total_steps - warmup_steps
                                           - hold_steps)
        hold = torch.full_like(t, eta)
        out = torch.where(t <= warmup_steps, warm,
                          torch.where(t <= warmup_steps + hold_steps, hold,
                                      decay))
        return torch.clamp(out, min=0.0)

    return sched


def constant(eta: float) -> Schedule:
    return lambda count: torch.full(
        (), eta, dtype=torch.float32, device=torch.as_tensor(count).device)


def sqrt_scaling_rule(eta_ref: float, batch_ref: int, batch: int) -> float:
    """LAMB's square-root LR scaling: eta = sqrt(batch/batch_ref) * eta_ref.

    The paper's point: this BREAKS past ~32-64K because eta exceeds the
    Lipschitz bound 1/L; eq. (9)'s hold phase is the fix.
    """
    return float(eta_ref * np.sqrt(batch / batch_ref))


def schedule_auc(sched: Schedule, total_steps: int) -> float:
    """Sum of eta_t over the schedule — the 'area under curve' of Fig. 1."""
    ts = torch.arange(total_steps, dtype=torch.int32)
    return float(torch.sum(sched(ts)))


@dataclasses.dataclass(frozen=True)
class StageSchedule:
    """One pretraining stage (paper §4 / Table 1)."""

    name: str
    batch_size: int
    seq_len: int
    total_steps: int
    eta: float
    ratio_warmup: float
    ratio_const: float

    @property
    def warmup_steps(self) -> int:
        return max(1, round(self.total_steps * self.ratio_warmup))

    @property
    def hold_steps(self) -> int:
        return max(0, round(self.total_steps * self.ratio_const))

    def schedule(self) -> Schedule:
        return warmup_hold_decay(
            self.eta, self.total_steps, self.warmup_steps, self.hold_steps
        )


def paper_stage_schedules() -> tuple:
    """Exact Table 1 / §4 settings: batches 96K/33K, 3519 + 782 steps."""
    stage1 = StageSchedule(
        name="phase1_seq128",
        batch_size=96 * 1024,
        seq_len=128,
        total_steps=3519,
        eta=0.00675,
        ratio_warmup=0.4265,
        ratio_const=0.2735,   # warmup + const = 70%
    )
    stage2 = StageSchedule(
        name="phase2_seq512",
        batch_size=33 * 1024,
        seq_len=512,
        total_steps=782,
        eta=0.005,
        ratio_warmup=0.192,
        ratio_const=0.108,    # warmup + const = 30%
    )
    return stage1, stage2


def figure1_settings() -> dict:
    """The exact Fig. 1 configuration for the AUC-gap reproduction."""
    return dict(total_steps=3519, warmup_steps=1500, hold_steps=963,
                eta_feasible=0.007, eta_ideal=0.01)
