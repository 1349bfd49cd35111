"""Sums that span ranks: the parts of the global batch's loss and
gradients, and the per-leaf sums of squares of a leaf cut over ranks.

A train step on a mesh (distributed/steps.py) gives every rank its block
of the global batch; the losses take their means over the whole batch
(models/common.py: WHOLE), so that each rank's loss and gradients are
its PARTS of the whole batch's, and `sum_over` adds them up.

The fused optimizers (core/optim/fused.py, precision/fused.py) run their
kernels on each rank's shard of a leaf. K1's sum of squares and K2's /
K5's norms are then partial sums, which `reduce_partials` adds over the
mesh dims the leaf is cut over, one all-reduce of a stacked batch per
group of leaves and mesh dim (counted in `reduce_partials.calls`).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def sum_over(t, groups):
    """A detached copy of `t` summed over the ranks of each process group
    in `groups`."""
    total = torch.as_tensor(t).detach().clone()
    for g in groups:
        dist.all_reduce(total, group=g)
    return total


def whole(t):
    """A DTensor's whole value as a plain tensor on every rank
    (full_tensor); any other tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def reduce_partials(t: torch.Tensor, groups) -> torch.Tensor:
    """Sum `t` (a stacked batch of partial sums) in place over each process
    group in `groups`; returns it."""
    for g in groups:
        dist.all_reduce(t, group=g)
        reduce_partials.calls += 1
    return t


reduce_partials.calls = 0
