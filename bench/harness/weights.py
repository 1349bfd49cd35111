"""The weights both sides start from, made on the device from the seed
by the benchmark (not by the program): one draw of N(0, 1) for every
"normal" leaf in one call, scaled by the configuration's
initializer_range and rounded to the precision the leaf lives in; the
other leaves are constants. Flat {path: tensor} dicts and the program's
nested trees convert into each other by the '/'-joined paths.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from bench.cost.lans import kept_fp32

LOW = {"bfloat16": torch.bfloat16, "float16": torch.float16,
       "float32": torch.float32}


def make(layout, conf: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{path: float32 tensor}: the initial master weights. A leaf that the
    policy keeps below float32 is drawn exactly representable there, so
    that the program's low-precision copy and its master hold the same
    values as the reference's float32 weights."""
    keep = conf["precision"]["keep_fp32"]
    low = LOW[conf["precision"]["param_dtype"]]
    normal = [(p, s) for p, s, init in layout if init == "normal"]
    for p, _ in normal:
        if kept_fp32(p, keep):
            raise ValueError(f"{p}: a drawn leaf kept in float32")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    n = sum(math.prod(s) for _, s in normal)
    buf = torch.randn(n, generator=gen, device=device)
    buf.mul_(conf["initializer_range"])
    buf.copy_(buf.to(low))
    out, at = {}, 0
    for p, s in normal:
        k = math.prod(s)
        out[p] = buf[at:at + k].view(s)
        at += k
    for p, s, init in layout:
        if init == "zeros":
            out[p] = torch.zeros(s, device=device)
        elif init == "ones":
            out[p] = torch.ones(s, device=device)
        elif init != "normal":
            raise ValueError(f"{p}: unknown init {init!r}")
    return {p: out[p] for p, _, _ in layout}


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = t
    return tree


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        v = tree[k]
        out.update(flatten(v, path) if isinstance(v, dict) else {path: v})
    return out
