"""The system under test: the port's train step (repro_torch), built as a
configuration file states it. The only module of the harness that
imports the program.

The step is repro_torch.distributed.steps.build_train_step(arch.loss_fn,
fused_mixed_lans(schedule, policy), ...) on one device. The transform is
wrapped once to read the gradient as the optimizer gets it in set-up
(`Capture`); in the window the wrapper only passes through.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from bench.harness import spec


def arch_of(conf: dict):
    """The port's Arch for the configuration: its registered arch with
    the file's sizes, every one checked against what the port runs, by
    bench/port/<kind>.py for the kind the configuration's reference
    names."""
    from repro_torch.configs import get_arch
    kind = conf["reference"]
    try:
        port = spec.kind_module("port", kind)
    except ModuleNotFoundError as e:
        if e.name != f"bench.port.{kind}":
            raise
        raise ValueError(f"{conf['port_arch']}: no bench/port/{kind}.py "
                         f"maps a configuration of kind {kind!r} onto "
                         f"the port") from None
    arch = get_arch(conf["port_arch"])
    dt = lambda name: getattr(torch, conf["precision"][name])
    cfg = dataclasses.replace(arch.cfg, compute_dtype=dt("compute_dtype"),
                              param_dtype=dt("param_dtype"),
                              **port.fields(conf))
    port.check(conf, cfg)
    return dataclasses.replace(arch, cfg=cfg)


def counters() -> Dict[str, int]:
    """The port's counters so far (repro_torch.metrics: a copy of a host
    dict; no device read, no sync)."""
    from repro_torch.metrics import counters as read
    return read()


class Capture:
    """A pass-through around the optimizer transform that, while `on`,
    keeps each gradient leaf it is handed (its first call): its norm, and
    a copy on the host, where it takes no device memory."""

    def __init__(self):
        self.on = True
        self.grad_norms: Optional[Dict[str, torch.Tensor]] = None
        self.grads: Optional[Dict[str, torch.Tensor]] = None

    def wrap(self, tx):
        from repro_torch.core.optim.base import tree_items
        from repro_torch.precision import MixedTransformation

        def update(grads, state, params):
            if self.on and self.grad_norms is None:
                self.grad_norms = {p: torch.linalg.vector_norm(
                    g.float()) for p, g in tree_items(grads)}
                self.grads = {p: g.detach().to("cpu", copy=True)
                              for p, g in tree_items(grads)}
            box = [grads]          # the transform frees each leaf it uses
            del grads
            return tx.update(box.pop(), state, params)
        return MixedTransformation(tx.init, update)


class Program:
    """The train step and its state, as one object from set-up to the
    end of the window."""

    def __init__(self, conf: dict, mix, make_params):
        from repro_torch.core.schedules import warmup_hold_decay
        from repro_torch.distributed.steps import build_train_step
        from repro_torch.precision import fused_mixed_lans, get_policy
        self.arch = arch_of(conf)
        s = mix.schedule
        if s["name"] != "warmup_hold_decay":
            raise ValueError(f"unknown schedule {s['name']!r}")
        sched = warmup_hold_decay(s["eta"], s["total_steps"],
                                  s["warmup_steps"], s["hold_steps"])
        pr, opt = conf["precision"], conf["optimizer"]
        if opt["name"] != "fused_mixed_lans":
            raise ValueError(f"unknown optimizer {opt['name']!r}")
        policy = get_policy(pr["policy"])
        if (str(policy.param_dtype), tuple(policy.keep_fp32)) != (
                f"torch.{pr['param_dtype']}", tuple(pr["keep_fp32"])):
            raise ValueError("the port's policy is not the configuration's")
        no_decay = tuple(opt["no_decay"])
        self.capture = Capture()
        tx = self.capture.wrap(fused_mixed_lans(
            sched, policy, beta1=opt["beta1"], beta2=opt["beta2"],
            eps=opt["eps"], weight_decay=opt["weight_decay"],
            decay_mask=lambda p: not any(w in p.lower() for w in no_decay)))
        self.step_fn, init = build_train_step(
            self.arch.loss_fn, tx, microbatches=mix.microbatches,
            param_init_fn=lambda _: make_params(), policy=policy)
        self.params, self.state = init(None)

    def step(self, batch) -> torch.Tensor:
        """One step on `batch` (device tensors); returns its loss tensor
        (not read: nothing waits for the device here)."""
        self.params, self.state, metrics = self.step_fn(
            self.params, self.state, batch)
        return metrics["loss"]

    def master(self) -> Dict[str, torch.Tensor]:
        """{path: the fp32 master weight} (a leaf kept fp32 is its own)."""
        from repro_torch.core.optim.base import tree_items
        from repro_torch.precision.mixed import _merge_master
        merged = _merge_master(self.state.master, self.params)
        return dict(tree_items(merged))
