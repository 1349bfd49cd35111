"""Precision policies (port of repro/precision/policy.py, inference side).

A `Policy` names the dtype of the model's parameter copy and the dtype
its matmuls run in; parameter leaves whose '/'-joined path matches a
`keep_fp32` substring (norm scales, biases) stay fp32 whatever the
policy. Ported: fp32, bf16 and bf16_compute. Loss scaling and the fp16
policy belong to training and are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

# LayerNorm/RMSNorm scales, every bias, and SSM stabilizers stay fp32.
KEEP_FP32 = ("bias", "scale", "layernorm", "ln_", "norm", "a_log")


def _map_with_path(tree, fn, prefix: str = ""):
    """fn(path, leaf) over a nested dict, paths '/'-joined as the JAX
    package's tree_paths joins them."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        out[k] = (_map_with_path(v, fn, path) if isinstance(v, dict)
                  else fn(path, v))
    return out


@dataclasses.dataclass(frozen=True)
class Policy:
    name: str
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    output_dtype: Any = torch.float32
    keep_fp32: Tuple[str, ...] = KEEP_FP32

    def leaf_dtype(self, path: str):
        low = path.lower()
        if any(s in low for s in self.keep_fp32):
            return torch.float32
        return self.param_dtype

    def cast_params(self, params):
        """Model-copy cast with per-block overrides (norms/biases stay
        fp32); integer leaves pass through."""
        return _map_with_path(
            params, lambda pth, x: x.to(self.leaf_dtype(pth))
            if x.is_floating_point() else x)

    def apply_to_cfg(self, cfg):
        """dataclasses.replace a model config's dtype fields."""
        kw = {}
        if hasattr(cfg, "compute_dtype"):
            kw["compute_dtype"] = self.compute_dtype
        if hasattr(cfg, "param_dtype"):
            kw["param_dtype"] = self.param_dtype
        return dataclasses.replace(cfg, **kw) if kw else cfg


_POLICIES = {
    "fp32": Policy("fp32"),
    "bf16": Policy("bf16", param_dtype=torch.bfloat16,
                   compute_dtype=torch.bfloat16),
    # compute-only cast: fp32 params, bf16 matmuls
    "bf16_compute": Policy("bf16_compute", compute_dtype=torch.bfloat16),
}
NOT_PORTED = ("fp16", "fp16_mixed")


def get_policy(name) -> Policy:
    if isinstance(name, Policy):
        return name
    if name in NOT_PORTED:
        raise NotImplementedError(f"precision policy {name!r} is not "
                                  f"ported yet; ported: {sorted(_POLICIES)}")
    if name not in _POLICIES:
        raise KeyError(f"unknown policy {name!r}; known: {sorted(_POLICIES)}")
    return _POLICIES[name]
