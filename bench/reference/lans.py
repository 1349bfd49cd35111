"""Plain reference of the LANS update (the paper's Algorithm 2, eqs. 5-7)
as the configuration file states it, on float32 master weights.

Per block (one parameter leaf, layers stacked), step t (1-indexed):
  g~ = g / ||g||                          (0 where ||g|| = 0)
  m  = b1 m + (1 - b1) g~,   v = b2 v + (1 - b2) g~^2
  r  = (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps) + lam x
  c  = g~ / (sqrt(v / (1 - b2^t)) + eps) + lam x
  x <- x - eta (b1 phi(r) r + (1 - b1) phi(c) c)
with phi(u) = ||x|| / ||u|| where ||u|| > 0, else 1. Leaves whose path
holds a `no_decay` substring take lam = 0 and phi = 1. eta follows the
job's schedule at the 0-indexed count t - 1. The bias corrections are
1 - b^t with b and t in float32.
"""
from __future__ import annotations

from typing import Dict

import torch


def schedule(sched: dict, count: int) -> float:
    """The learning rate at the 0-indexed step `count` (eq. 9: linear
    warmup, constant hold, linear decay)."""
    if sched["name"] != "warmup_hold_decay":
        raise ValueError(f"unknown schedule {sched['name']!r}")
    eta, total = sched["eta"], sched["total_steps"]
    warm, hold = sched["warmup_steps"], sched["hold_steps"]
    t = torch.tensor(float(count), dtype=torch.float32) + 1.0
    if t <= warm:
        out = eta * t / warm
    elif t <= warm + hold:
        out = torch.tensor(eta, dtype=torch.float32)
    else:
        out = eta * (total - t) / (total - warm - hold)
    return float(torch.clamp(torch.as_tensor(out, dtype=torch.float32),
                             min=0.0))


def decays(path: str, no_decay) -> bool:
    low = path.lower()
    return not any(s in low for s in no_decay)


def update(x: Dict[str, torch.Tensor], g: Dict[str, torch.Tensor],
           m: Dict[str, torch.Tensor], v: Dict[str, torch.Tensor], t: int,
           eta: float, opt: dict):
    """One LANS step over every leaf, in place on x, m and v."""
    b1, b2, eps = opt["beta1"], opt["beta2"], opt["eps"]
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)
    bc1 = float(1.0 - f32(b1) ** f32(float(t)))
    bc2 = float(1.0 - f32(b2) ** f32(float(t)))
    for path in x:
        on = decays(path, opt["no_decay"])
        lam = opt["weight_decay"] if on else 0.0
        gf = g[path].float()
        gn = torch.linalg.vector_norm(gf)
        gt = torch.where(gn > 0, gf / torch.clamp(gn, min=1e-30),
                         torch.zeros_like(gf))
        m[path].mul_(b1).add_((1 - b1) * gt)
        v[path].mul_(b2).add_((1 - b2) * gt * gt)
        denom = torch.sqrt(v[path] / bc2) + eps
        xp = x[path]
        r = (m[path] / bc1) / denom + lam * xp
        c = gt / denom + lam * xp
        if on:
            xn = torch.linalg.vector_norm(xp)
            rn, cn = torch.linalg.vector_norm(r), torch.linalg.vector_norm(c)
            sr = torch.where(rn > 0, xn / torch.clamp(rn, min=1e-30), 1.0)
            sc = torch.where(cn > 0, xn / torch.clamp(cn, min=1e-30), 1.0)
        else:
            sr = sc = 1.0
        xp.sub_(eta * (b1 * sr * r + (1 - b1) * sc * c))
