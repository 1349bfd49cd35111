"""Named spans and counters of the port's own layers.

Spans are torch.profiler ranges named "repro/<name>", so they land in
any torch.profiler trace (its Chrome export included) beside the aten
ops and on the device ops' clock. `span(name)` records only while a
profiler session runs; at every other time (the timed steps of a run,
the dry run on meta tensors) it returns one shared null context after
a single read of the profiler's flag: no object, no autograd node, no
change to any number.

    train.step          distributed/steps.py: step_fn, mesh_step_fn
    train.forward       loss_and_grads: the loss function's call
    train.backward      loss_and_grads: the torch.autograd.grad call
    train.update        the step's update (gradient norm, transform)
    model.attention     models/attention.py: attn_apply
    model.moe.route     models/moe.py: moe_apply's router, top-k,
                        capacity positions (one scan over an
                        expert-major one-hot), kept pairs and aux terms
    model.moe.experts   moe_apply's dispatch, expert MLPs and combine
    model.head          BERT's MLM and NSP heads and their loss; a
                        decoder's readout and its loss
    sync.finite_flag    precision/mixed.py: read_finite, the host's
                        read of the step's finite flag
    sync.moe_counts     models/moe.py: _expert_counts, the host's read of
                        the routed rows per expert

A checkpointed region recomputed in the backward pass opens its spans
again, on the thread that runs the backward pass.

Counters are a plain dict of ints, always on; each adds only what the
host already holds (never a device read, a sync or a tensor op):

    train.steps           train steps called
    sync.finite_flag      reads of the finite flag
    optim.skipped_steps   steps whose finite flag read false
    sync.moe_counts       reads of the expert counts (the forward pass
                          and its recomputation each read once a layer)
    moe.pairs_routed      (token, expert) pairs routed at those reads,
    moe.pairs_dropped     and of them those past their expert's capacity:
                          counted where the rank holds every expert and
                          no token is padding

Callers read `counters()` before and after what they measure and take
the difference (launch/train.py logs it each step).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict

import torch

PREFIX = "repro/"
SPANS = ("train.step", "train.forward", "train.backward", "train.update",
         "model.attention", "model.moe.route", "model.moe.experts",
         "model.head", "sync.finite_flag", "sync.moe_counts")

_NULL = contextlib.nullcontext()
# True on every thread of a process while a profiler session runs (the
# autograd engine's threads inherit the session)
_profiling = torch.autograd._profiler_enabled
# the backward pass counts on the autograd engine's thread
_counts: Dict[str, int] = {}
_lock = threading.Lock()


def span(name: str):
    """A context naming its block "repro/<name>" in a profiler trace, or
    the shared null context while no profiler runs."""
    if not _profiling():
        return _NULL
    return torch.profiler.record_function(PREFIX + name)


def count(name: str, n: int = 1) -> None:
    """Add `n`, a number the host holds, to counter `name`."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A copy of every counter so far."""
    with _lock:
        return dict(_counts)
