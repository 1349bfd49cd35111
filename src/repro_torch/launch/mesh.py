"""Mesh builders (port of repro/launch/mesh.py): DeviceMeshes with the JAX
package's axis names and shapes.

Single pod:  (data=16, model=16)
Multi-pod:   (pod=2, data=16, model=16); "pod" is a pure data-parallel
axis, the paper's scale-out pattern (192 instances x 8 GPUs ~ an outer
data-parallel axis).

A mesh spans the ranks of the initialised default process group, which
the caller sets up (`torch.distributed.init_process_group` with its own
address, world size and rank, and the backend it names). A mesh never
has fewer ranks than asked: a world of another size raises. Functions,
not module-level constants: importing this module touches no device or
process group. `join_launched_group` joins the group a launcher such as
torchrun describes in the environment (the serve CLI's --mesh).
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist


def _mk(shape, axes, device: str):
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        if n > 1:
            raise RuntimeError(
                f"a {'x'.join(map(str, shape))} mesh needs {n} ranks: "
                f"initialise the default process group first")
        # one rank: a process group of its own, over an in-memory store
        dist.init_process_group("gloo" if device == "cpu" else "nccl",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    world = dist.get_world_size()
    if world != n:
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh needs {n} ranks, the "
            f"process group has {world}")
    return DeviceMesh(device, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mk(shape, axes, device)


def join_launched_group(device: torch.device) -> torch.device:
    """Join the process group that a launcher (torchrun) describes in the
    environment (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT),
    unless a group is initialised already or none is described. Returns
    this rank's device: on CUDA, card LOCAL_RANK (or the rank) where
    there is a card per rank, joined with NCCL, else card 0, joined with
    gloo (NCCL refuses two ranks on one card); gloo on the CPU."""
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world = int(os.environ.get("WORLD_SIZE", 1))
        rank = int(os.environ.get("RANK", 0))
    local = int(os.environ.get("LOCAL_RANK", rank))
    own_card = (device.type == "cuda"
                and torch.cuda.device_count() >= world > 1)
    if own_card:
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        dist.init_process_group("nccl" if own_card else "gloo",
                                init_method="env://")
    return device


def make_local_mesh(*, data: int = 1, model: int = 1, device: str = "cuda"):
    """A (data, model) mesh over the ranks of the default process group
    (tests, examples, one host). A 1 x 1 mesh without a process group
    starts a one-rank group of its own."""
    return _mk((data, model), ("data", "model"), device)


# NVIDIA H100 SXM hardware constants for the roofline model (per card).
# Source: NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W
# power limit; a card set below 700 W runs slower under load.
PEAK_FLOPS = {
    "bfloat16": 989e12,      # tensor cores
    "float16": 989e12,       # tensor cores
    "tf32": 495e12,          # fp32 matmuls with TF32 allowed
    "float32": 67e12,        # fp32 outside the tensor cores
}
# the rate the one-FLOP-per-element ops (elementwise, reductions) are
# charged at: fp32 outside the tensor cores
PEAK_FLOPS["elementwise"] = PEAK_FLOPS["float32"]
HBM_BW = 3.35e12             # bytes/s, HBM3
HBM_BYTES = 80e9             # bytes
# NVLink 4, each way, per card. The production mesh's "model" axis of 16
# spans two 8-card hosts, so that its traffic crosses between hosts; the
# roofline charges it at this rate all the same and adds no term for it.
NVLINK_BW = 4.5e11           # bytes/s (450 GB/s)
