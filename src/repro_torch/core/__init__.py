"""Core contribution of the paper: LANS optimizer + large-batch LR schedules
(port of repro/core)."""
from repro_torch.core import optim, schedules  # noqa: F401
