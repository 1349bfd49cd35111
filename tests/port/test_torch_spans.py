"""The port's spans and counters (repro_torch/metrics/spans.py):

- with no profiler running a span is one shared null context that adds
  no autograd node, and a step of a tiny BERT and of a tiny MoE decoder
  gives the same bits with its spans recording as without;
- under torch.profiler on the CPU every span the port names appears in
  the trace, and a checkpointed layer opens its spans again in the
  backward pass;
- the counters read one finite-flag read a step, one count read per MoE
  layer and pass (recomputation included), a skipped step per overflow,
  and routed and dropped pairs equal to those recomputed from the
  routing; the training launcher's JSONL carries them a step;
- the dry run counts the same with the spans recording;
- counts from many threads at once are none of them lost.
"""
import contextlib
import dataclasses
import io
import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from port import mesh_worker
from repro_torch.configs import reduced_arch
from repro_torch.core.optim import lans
from repro_torch.core.optim.base import tree_items
from repro_torch.distributed.steps import build_train_step
from repro_torch.launch import dryrun
from repro_torch.launch import train as ttrain
from repro_torch.metrics import counters, read_metrics, span
from repro_torch.metrics import spans
from repro_torch.models import moe
from repro_torch.precision import fused_mixed_lans, get_policy

LR = 1e-3
ARCHS = ["bert-large", "granite-moe-3b-a800m"]


@pytest.fixture
def gathered(monkeypatch):
    """The MoE layers take the gathered route (the one that reads the
    expert counts on the host) at the tiny sizes too."""
    monkeypatch.setattr(moe, "DENSE_ROWS", 0)


def _batch(arch, rows=4):
    rng = np.random.default_rng(0)
    if arch.kind == "bert":
        seq = mesh_worker.SEQ
        tok = rng.integers(0, arch.cfg.vocab, size=(rows, seq))
        b = {"tokens": tok.astype(np.int32),
             "token_types": np.zeros((rows, seq), np.int32),
             "mlm_labels": np.where(rng.random((rows, seq)) < 0.15, tok,
                                    -100).astype(np.int32),
             "nsp_labels": rng.integers(0, 2, (rows,)).astype(np.int32)}
    else:
        b = mesh_worker.lm_batch(rng, arch.cfg, rows)
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _steps(name, n=2, policy="bf16"):
    """(step_fn, params, state, batch) of reduced `name` with the fused
    mixed LANS transform, as the benchmark runs it."""
    arch = reduced_arch(name)
    pol = get_policy(policy)
    arch = dataclasses.replace(arch, cfg=pol.apply_to_cfg(arch.cfg))
    step, init = build_train_step(arch.loss_fn, fused_mixed_lans(LR, pol),
                                  param_init_fn=arch.init, policy=pol)
    params, state = init(torch.Generator().manual_seed(0))
    return arch, step, params, state, _batch(arch)


def _run(step, params, state, batch, n):
    losses = []
    for _ in range(n):
        params, state, m = step(params, state, batch)
        losses.append(m["loss"])
    return params, losses


def _delta(before):
    """The counters that changed since `before`, by how much."""
    return {k: v - before.get(k, 0) for k, v in counters().items()
            if v != before.get(k, 0)}


def _names(prof):
    return {e.name for e in prof.events()}


def test_span_without_a_profiler_is_one_null_context():
    assert span("train.step") is span("model.attention")
    x = torch.ones(3, requires_grad=True)
    with span("model.head"):
        y = x * 2
    assert y.grad_fn.next_functions[0][0].variable is x
    assert not torch.autograd._profiler_enabled()


@pytest.mark.parametrize("name", ARCHS)
def test_spans_change_no_bit_of_a_step(name, gathered):
    _, step, params, state, batch = _steps(name)
    plain, plain_losses = _run(step, params, state, batch, 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        spanned, losses = _run(step, params, state, batch, 2)
    assert spans.PREFIX + "train.step" in _names(prof)
    assert torch.equal(torch.stack(plain_losses), torch.stack(losses))
    for (p, a), (_, b) in zip(tree_items(plain), tree_items(spanned)):
        assert torch.equal(a, b), p


def test_every_span_appears_in_a_profiler_trace(gathered):
    seen = set()
    for name in ARCHS:
        _, step, params, state, batch = _steps(name)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _run(step, params, state, batch, 1)
        seen |= _names(prof)
    assert {spans.PREFIX + s for s in spans.SPANS} <= seen


def test_a_recomputed_layer_opens_its_spans_in_the_backward_pass(gathered):
    arch, step, params, state, batch = _steps("granite-moe-3b-a800m")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(step, params, state, batch, 1)
    ranges = {}
    for e in prof.events():
        if e.name.startswith(spans.PREFIX):
            r = e.time_range
            ranges.setdefault(e.name[len(spans.PREFIX):], []).append(
                (r.start, r.end))
    (b0, b1), = ranges["train.backward"]
    n = arch.cfg.n_layers
    for s in ("model.attention", "model.moe.route", "model.moe.experts",
              "sync.moe_counts"):
        inside = [a for a, _ in ranges[s] if b0 <= a < b1]
        assert len(ranges[s]) == 2 * n and len(inside) == n, s


@pytest.mark.parametrize("name", ARCHS)
def test_counters_a_step(name, gathered):
    arch, step, params, state, batch = _steps(name)
    before = counters()
    _run(step, params, state, batch, 3)
    d = _delta(before)
    moe_layers = arch.cfg.n_layers if arch.kind == "decoder" else 0
    assert d["train.steps"] == 3 and d["sync.finite_flag"] == 3
    assert d.get("optim.skipped_steps", 0) == 0
    # the forward pass and its recomputation each read once a layer
    assert d.get("sync.moe_counts", 0) == 3 * 2 * moe_layers
    tokens = batch["tokens"].numel()
    assert d.get("moe.pairs_routed", 0) == (
        3 * 2 * moe_layers * tokens * getattr(arch.cfg, "top_k", 0))


def test_skipped_steps_are_the_overflows():
    _, step, params, state, batch = _steps("bert-large", policy="fp16")
    before = counters()
    for _ in range(3):
        params, state, m = step(params, state, batch)
    d = _delta(before)
    assert d["sync.finite_flag"] == 3
    assert d.get("optim.skipped_steps", 0) == int(m["overflow_count"])


def _drops(probs, k, cap):
    """Pairs past their expert's capacity, recomputed from the router's
    probabilities (G, T, E): top k per token, token-major positions."""
    dropped = 0
    for g in range(probs.shape[0]):
        filled = {}
        for t in range(probs.shape[1]):
            for e in torch.topk(probs[g, t], k).indices.tolist():
                filled[e] = filled.get(e, 0) + 1
                dropped += filled[e] > cap
    return dropped


@pytest.mark.parametrize("factor", [0.5, 1.0, 1.25])
def test_dropped_pairs_are_the_routing_s(factor, gathered):
    cfg = moe.MoeConfig(d_model=16, d_ff=8, n_experts=4, top_k=2,
                        capacity_factor=factor)
    gen = torch.Generator().manual_seed(1)
    p = moe.moe_init(gen, cfg)
    x = torch.randn(2, 24, 16, generator=gen)
    before = counters()
    moe.moe_apply(p, cfg, x, compute_dtype=torch.float32)
    d = _delta(before)
    probs = torch.softmax(x.reshape(1, 48, 16) @ p["router"]["kernel"], -1)
    cap = max(1, int(factor * 48 * 2 / 4))
    assert d["sync.moe_counts"] == 1
    assert d["moe.pairs_routed"] == 48 * 2
    dropped = _drops(probs, 2, cap)
    assert d.get("moe.pairs_dropped", 0) == dropped
    assert (dropped > 0) == (factor < 1.25)
    # padding routes nowhere: the pairs are not counted, the read is
    before = counters()
    moe.moe_apply(p, cfg, x, compute_dtype=torch.float32,
                  valid=torch.ones(2, 24, dtype=torch.bool))
    d = _delta(before)
    assert d == {"sync.moe_counts": 1}


def test_launcher_logs_the_counters_a_step(tmp_path, gathered):
    path = str(tmp_path / "m.jsonl")
    with contextlib.redirect_stdout(io.StringIO()):
        ttrain.main(["--device", "cpu", "--arch", "granite-moe-3b-a800m",
                     "--steps", "2", "--batch", "2", "--seq", "32",
                     "--precision", "bf16", "--metrics", path])
    recs = list(read_metrics(path))
    assert len(recs) == 2
    layers = reduced_arch("granite-moe-3b-a800m").cfg.n_layers
    for r in recs:
        assert r["sync.finite_flag"] == 1
        assert r["optim.skipped_steps"] == 0
        assert r["sync.moe_counts"] == 2 * layers
        assert r["moe.pairs_routed"] == 2 * layers * 2 * 32 * 2
        assert 0 <= r["moe.pairs_dropped"] <= r["moe.pairs_routed"]
    assert json.dumps(recs)


@pytest.mark.parametrize("name", ARCHS)
def test_the_dry_run_counts_the_same_with_spans_recording(name):
    arch = reduced_arch(name)
    batch = _batch(arch)
    before = counters()
    plain, _ = dryrun.trace_train(arch, batch, tx=lans(LR))
    with profile(activities=[ProfilerActivity.CPU]):
        spanned, _ = dryrun.trace_train(arch, batch, tx=lans(LR))
    for key in ("flops_by_dtype", "bytes_accessed", "collective_bytes",
                "collective_counts"):
        assert plain[key] == spanned[key], key
    d = _delta(before)
    # meta tensors: nothing is read from a device
    assert d == {"train.steps": 2}


def test_counts_from_many_threads_are_not_lost():
    before = counters().get("test.threads", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [
            spans.count("test.threads") for _ in range(2000)])
            for _ in range(16)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert counters()["test.threads"] - before == 16 * 2000
