"""Precision policies of the port (inference side)."""
from repro_torch.precision.policy import KEEP_FP32, Policy, get_policy

__all__ = ["KEEP_FP32", "Policy", "get_policy"]
