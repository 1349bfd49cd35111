"""Checkpoints of nested dicts of tensors (port of
repro/checkpoint/checkpoint.py), in the JAX package's layout so that a
checkpoint crosses frameworks:

    <dir>/step_<N:08d>/arrays.npz     one array per '/'-joined leaf path
    <dir>/step_<N:08d>/manifest.json  step, paths (sorted-key order), metadata

numpy has no bfloat16, so bf16 leaves are written as fp32 (exact) and
cast back to the dtype of `like` on restore; the JAX package's restore
casts the same way.
"""
from __future__ import annotations

import json
import os
import re
from typing import Optional

import numpy as np
import torch

from repro_torch.core.optim.base import tree_items, tree_map, tree_paths


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def save(ckpt_dir: str, step: int, tree, *, metadata: Optional[dict] = None):
    out = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(out, exist_ok=True)
    items = tree_items(tree)
    paths = [p for p, _ in items]
    np.savez(os.path.join(out, "arrays.npz"),
             **{p: _to_numpy(v) for p, v in items})
    manifest = {"step": step, "treedef": "nested dict", "paths": paths,
                "metadata": metadata or {}}
    with open(os.path.join(out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for d in os.listdir(ckpt_dir)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like):
    """Restore into the structure, dtypes and devices of ``like`` (leaf
    paths must match)."""
    src = os.path.join(ckpt_dir, f"step_{step:08d}")
    data = np.load(os.path.join(src, "arrays.npz"))
    paths = dict(tree_items(like))
    loaded = {}
    for p, v in paths.items():
        if p not in data:
            raise KeyError(f"checkpoint missing {p}")
        arr = data[p]
        if arr.shape != tuple(v.shape):
            raise ValueError(f"{p}: shape {arr.shape} != {tuple(v.shape)}")
        if arr.dtype.name == "bfloat16":     # written by the JAX package
            arr = arr.astype(np.float32)
        loaded[p] = torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=v.device, dtype=v.dtype)
    return tree_map(lambda pth: loaded[pth], tree_paths(like))
