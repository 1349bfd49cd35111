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

# the configuration file's keys and the port's config fields they set
FIELDS = {
    "bert": {"hidden_size": "d_model", "num_hidden_layers": "n_layers",
             "num_attention_heads": "n_heads", "intermediate_size": "d_ff",
             "vocab_size": "vocab", "max_position_embeddings": "max_pos",
             "type_vocab_size": "type_vocab"},
    "decoder": {"hidden_size": "d_model", "num_hidden_layers": "n_layers",
                "num_attention_heads": "n_heads",
                "num_key_value_heads": "n_kv_heads",
                "intermediate_size": "d_ff", "vocab_size": "vocab",
                "num_local_experts": "n_experts",
                "num_experts_per_tok": "top_k",
                "capacity_factor": "capacity_factor",
                "rope_theta": "rope_theta",
                "tie_word_embeddings": "tie_embeddings"},
}


def arch_of(conf: dict):
    """The port's Arch for the configuration: its registered arch with
    the file's sizes, every one checked against what the port runs."""
    from repro_torch.configs import get_arch
    arch = get_arch(conf["port_arch"])
    fields = FIELDS[arch.kind]
    kw = {f: conf[k] for k, f in fields.items() if k in conf}
    if arch.kind == "decoder":
        kw["head_dim"] = conf["hidden_size"] // conf["num_attention_heads"]
    dt = lambda name: getattr(torch, conf["precision"][name])
    cfg = dataclasses.replace(arch.cfg, compute_dtype=dt("compute_dtype"),
                              param_dtype=dt("param_dtype"), **kw)
    fixed = {"bert": {"layer_norm_eps": 1e-6},
             "decoder": {"rms_norm_eps": 1e-6, "embedding_multiplier": 1.0,
                         "attention_multiplier":
                             cfg.resolved_head_dim ** -0.5
                             if arch.kind == "decoder" else None,
                         "residual_multiplier": 1.0, "logits_scaling": 1.0,
                         "router_aux_loss_coef": 0.01}}[arch.kind]
    for k, v in fixed.items():
        if conf[k] != v:
            raise ValueError(f"{k} = {conf[k]}: the port runs {v}")
    if arch.kind == "decoder":
        if cfg.superblock != (("attn", "moe"),) or cfg.qkv_bias \
                or cfg.qk_norm or cfg.scale_embeds or cfg.final_softcap \
                or cfg.attn_softcap or not cfg.gated_mlp \
                or cfg.activation != conf["hidden_act"]:
            raise ValueError(f"{conf['port_arch']}: the port's decoder is "
                             f"not the one the configuration states")
    return dataclasses.replace(arch, cfg=cfg)


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
