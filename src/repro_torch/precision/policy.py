"""Precision policies: which dtype each part of the training and serving
state lives in (port of repro/precision/policy.py).

A `Policy` names four dtypes plus the per-block override list:

  param_dtype    dtype of the model's parameter copy (what loss_fn sees)
  compute_dtype  dtype matmuls/attention run in (models cast at use)
  output_dtype   dtype step outputs (logits/loss) are returned in
  moment_dtype   storage dtype of optimizer first/second moments (math is
                 always fp32 inside the optimizers; see lans mu_dtype)

Per-block overrides (`keep_fp32`): parameter leaves whose '/'-joined
path matches any substring stay fp32 whatever param_dtype says —
LayerNorm scales/biases and other 1-D stabilizer params, as in apex O2.

The named policies:

  fp32          everything fp32 (no wrapper needed)
  bf16          bf16 params/compute and moments, fp32 master weights,
                static scale 1 (bf16 has fp32's exponent range)
  fp16_mixed    fp16 params/compute, bf16 moments, fp32 master weights,
  (alias fp16)  dynamic loss scaling with skip-and-halve on overflow
  bf16_compute  fp32 params, bf16 matmuls (serving; no wrapper needed)

Casting touches floating leaves only; integer leaves pass through.
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


def _is_float(x) -> bool:
    return torch.is_tensor(x) and x.is_floating_point()


def tree_cast(tree, dtype):
    """Cast every floating leaf to `dtype`; other leaves untouched."""
    return _map_with_path(tree, lambda _, x: x.to(dtype) if _is_float(x)
                          else x)


@dataclasses.dataclass(frozen=True)
class Policy:
    name: str
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    output_dtype: Any = torch.float32
    moment_dtype: Any = torch.float32
    keep_fp32: Tuple[str, ...] = KEEP_FP32
    loss_scaling: str = "none"  # "none" | "static" | "dynamic"

    def leaf_dtype(self, path: str):
        low = path.lower()
        if any(s in low for s in self.keep_fp32):
            return torch.float32
        return self.param_dtype

    @property
    def needs_master(self) -> bool:
        """True when the model copy loses bits vs fp32 master weights."""
        return self.param_dtype != torch.float32

    @property
    def wants_wrapper(self) -> bool:
        """True when training needs mixed_precision() around the
        optimizer."""
        return self.needs_master or self.loss_scaling != "none"

    def cast_params(self, params):
        """Model-copy cast with per-block overrides (norms/biases stay
        fp32); integer leaves pass through."""
        return _map_with_path(
            params, lambda pth, x: x.to(self.leaf_dtype(pth))
            if _is_float(x) else x)

    def cast_to_compute(self, tree):
        return tree_cast(tree, self.compute_dtype)

    def cast_output(self, x):
        if isinstance(x, dict):
            return tree_cast(x, self.output_dtype)
        return x.to(self.output_dtype) if _is_float(x) else x

    def make_loss_scale(self):
        from repro_torch.precision.loss_scale import (DynamicLossScale,
                                                      StaticLossScale)
        if self.loss_scaling == "dynamic":
            return DynamicLossScale()
        return StaticLossScale()

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
                   compute_dtype=torch.bfloat16, output_dtype=torch.float32,
                   moment_dtype=torch.bfloat16, loss_scaling="static"),
    "fp16_mixed": Policy("fp16_mixed", param_dtype=torch.float16,
                         compute_dtype=torch.float16,
                         output_dtype=torch.float32,
                         moment_dtype=torch.bfloat16,
                         loss_scaling="dynamic"),
    # compute-only cast: fp32 params, bf16 matmuls — no wrapper needed
    "bf16_compute": Policy("bf16_compute", compute_dtype=torch.bfloat16),
}
_POLICIES["fp16"] = _POLICIES["fp16_mixed"]


def get_policy(name) -> Policy:
    if isinstance(name, Policy):
        return name
    if name not in _POLICIES:
        raise KeyError(f"unknown policy {name!r}; known: {sorted(_POLICIES)}")
    return _POLICIES[name]
