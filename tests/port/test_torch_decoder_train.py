"""Causal-LM pretraining of the dense decoders on the port, against the
JAX package: Arch.loss_fn's loss and every gradient for reduced
gemma2-2b, qwen2.5-14b (QKV bias), mistral-nemo-12b (sliding window),
chameleon-34b (QK-norm, embedding inputs) and an untied-head qwen, from
params carried over by repro_torch.bridge; remat on and off; the
chunked-loss rule; build_train_step trajectories with LANS, fused LANS
(plain versions here), LAMB and AdamW; the LM data streams; the CLI; the
bridge on the new param trees; and the port's quickstart.

Tolerances: the loss and gradients 1e-5 (rtol and atol), fp32 compute
on both sides, summed in another order; remat on vs off 1e-6 (the same
arithmetic, recomputed); fp32-policy trajectories 1e-4 relative over 4
steps (test_torch_train.py's); the quickstart's bf16-compute losses 3e-2
relative (test_torch_train.py's bf16 tolerance: bf16 matmuls round at
other places in XLA and PyTorch).
"""
import contextlib
import dataclasses
import functools
import importlib.util
import io
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_arch as jreduced
from repro.core import schedules as jsched
from repro.core.optim import adamw as jadamw
from repro.core.optim import apply_updates as japply
from repro.core.optim import lamb as jlamb
from repro.core.optim import lans as jlans
from repro.core.optim.fused import fused_lans as jfused_lans
from repro.data.corpus import SyntheticCorpus as JCorpus
from repro.data.corpus import lm_batch_iterator as jlm
from repro.data.sharding import ShardSpec as JShard
from repro.distributed.steps import build_train_step as jbuild
from repro.distributed.steps import jit_train_step
from repro.launch.mesh import make_local_mesh
from repro.launch.train import make_data as jmake_data
from repro.models import decoder as jdec
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.core import schedules as tsched
from repro_torch.core.optim import adamw as tadamw
from repro_torch.core.optim import fused_lans as tfused_lans
from repro_torch.core.optim import lamb as tlamb
from repro_torch.core.optim import lans as tlans
from repro_torch.core.optim.base import tree_items
from repro_torch.distributed.steps import build_train_step as tbuild
from repro_torch.distributed.steps import loss_and_grads
from repro_torch.launch import train as ttrain
from repro_torch.models import decoder as tdec

F32 = dict(rtol=1e-5, atol=1e-5)
ROOT = pathlib.Path(__file__).resolve().parents[2]
ARCHS = ["gemma2-2b", "qwen2.5-14b", "mistral-nemo-12b", "chameleon-34b",
         "qwen2.5-14b-untied"]


@functools.lru_cache(maxsize=None)
def _pair(name, compute="fp32"):
    """(JAX arch, JAX params, port arch, port params) of a reduced arch
    with `compute` matmuls on both sides; "-untied" unties the head."""
    base = name.replace("-untied", "")
    over = dict(compute_dtype=jnp.float32 if compute == "fp32"
                else jnp.bfloat16)
    tover = dict(compute_dtype=torch.float32 if compute == "fp32"
                 else torch.bfloat16)
    if name.endswith("-untied"):
        over["tie_embeddings"] = tover["tie_embeddings"] = False
    ja, ta = jreduced(base), tconfigs.reduced_arch(base)
    ja = dataclasses.replace(ja, cfg=dataclasses.replace(ja.cfg, **over))
    ta = dataclasses.replace(ta, cfg=dataclasses.replace(ta.cfg, **tover))
    jp = jax.jit(ja.init)(jax.random.PRNGKey(0))
    tp = params_from_jax(ta.cfg, jax.tree.map(np.asarray, jp))
    return ja, jp, ta, tp


def _batches(arch, n, *, batch=2, seq=32, seed=0):
    """n LM batches (numpy) from the JAX launcher's data stream: tokens
    and labels, or embeddings and labels for an embeds_input arch."""
    it = jmake_data(arch, batch=batch, seq=seq, seed=seed)
    return [next(it) for _ in range(n)]


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_jax(name):
    ja, jp, ta, tp = _pair(name)
    b = _batches(ja, 1)[0]
    assert ("embeds" in b) == (name == "chameleon-34b")
    (want, jaux), jg = jax.value_and_grad(ja.loss_fn, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    loss, aux, grads = loss_and_grads(ta.loss_fn, tp, _t(b), None)
    np.testing.assert_allclose(float(loss), float(want), **F32)
    assert float(aux["router_entropy"]) == float(jaux["router_entropy"])
    jleaves = jax.tree.leaves(jg)
    titems = tree_items(grads)
    assert len(titems) == len(jleaves)
    for (path, g), j in zip(titems, jleaves):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(j), err_msg=path,
                                   **F32)
    if name == "chameleon-34b":
        assert "q_norm" in grads["slot0"]["mixer"]
    if name.endswith("-untied"):
        assert float(grads["lm_head"]["kernel"].abs().sum()) > 0


@pytest.mark.parametrize("name", ["gemma2-2b", "chameleon-34b"])
def test_remat_does_not_change_grads(name):
    """Recomputing each period in the backward pass (cfg.remat, the
    default) gives the gradients of keeping every activation."""
    _, _, ta, tp = _pair(name)
    b = _t(_batches(ta, 1)[0])
    out = []
    for remat in (True, False):
        arch = dataclasses.replace(ta, cfg=dataclasses.replace(
            ta.cfg, remat=remat))
        out.append(loss_and_grads(arch.loss_fn, tp, b, None))
    assert float(out[0][0]) == pytest.approx(float(out[1][0]), rel=1e-6)
    for (path, a), (_, c) in zip(tree_items(out[0][2]),
                                 tree_items(out[1][2])):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=path)


def test_remat_recomputes_each_period():
    """With remat the forward keeps only each period's input for the
    backward pass (plus the head's and the loss's), far fewer saved
    tensors than without."""
    _, _, ta, tp = _pair("gemma2-2b")
    b = _t(_batches(ta, 1)[0])
    counts = []
    for remat in (True, False):
        arch = dataclasses.replace(ta, cfg=dataclasses.replace(
            ta.cfg, remat=remat))
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t.numel()) or t, lambda t: t):
            live = {k: v for k, v in tp.items()}
            live = jax.tree.map(lambda t: t.detach().requires_grad_(True),
                                live)
            arch.loss_fn(live, b)
        counts.append(len(saved))
    assert counts[0] * 4 < counts[1], counts


# (vocab, seq) -> whether the JAX rule takes the chunked loss
RULE = [((65536, 1024), True), ((65535, 1024), False),
        ((65536, 512), False), ((65536, 1536), True),
        ((131072, 1000), False), ((152064, 2048), True)]


@pytest.mark.parametrize("shape,chunked", RULE)
def test_loss_fn_takes_the_chunked_branch_by_the_jax_rule(monkeypatch, shape,
                                                          chunked):
    """Arch.loss_fn picks chunked_lm_loss exactly when the JAX package's
    does (vocab >= 65536, seq >= 1024 and a multiple of 512): the forward
    and both losses are replaced by recorders on both sides, so only the
    rule runs at these sizes."""
    vocab, seq = shape
    seen = {"jax": [], "torch": []}
    for side, mod in (("jax", jdec), ("torch", tdec)):
        zeros = (jnp.zeros if side == "jax" else torch.zeros)

        def apply(params, cfg, tokens=None, *, embeds=None,
                  return_hidden=False, _z=zeros, **kw):
            aux = {"moe_aux_loss": _z(()), "router_entropy": _z(())}
            return _z((1, seq, 4)), None, aux

        monkeypatch.setattr(mod, "decoder_apply", apply)
        monkeypatch.setattr(mod, "chunked_lm_loss",
                            lambda *a, _s=side, **k: seen[_s].append(True)
                            or 0.0)
        monkeypatch.setattr(mod, "lm_loss",
                            lambda *a, _s=side, **k: seen[_s].append(False)
                            or 0.0)
    ja = jreduced("qwen2.5-14b")
    ta = tconfigs.reduced_arch("qwen2.5-14b")
    ja = dataclasses.replace(ja, cfg=dataclasses.replace(ja.cfg, vocab=vocab))
    ta = dataclasses.replace(ta, cfg=dataclasses.replace(ta.cfg, vocab=vocab))
    labels = np.zeros((1, seq), np.int32)
    ja.loss_fn(None, {"tokens": jnp.asarray(labels),
                      "labels": jnp.asarray(labels)})
    ta.loss_fn(None, {"tokens": torch.from_numpy(labels),
                      "labels": torch.from_numpy(labels)})
    assert seen["torch"] == seen["jax"] == [chunked]


def test_chunked_loss_fn_at_a_big_vocab_matches_jax():
    """The real chunked branch through Arch.loss_fn: vocab 65536, seq 1024
    (two chunks of 512), batch 1, one layer, narrow widths: loss and the
    gradient of the tied embedding against JAX."""
    over = dict(vocab=65536, n_layers=1, d_model=64, n_heads=2,
                n_kv_heads=2, head_dim=32, d_ff=64, max_seq=1024)
    ja = jreduced("qwen2.5-14b")
    ta = tconfigs.reduced_arch("qwen2.5-14b")
    ja = dataclasses.replace(ja, cfg=dataclasses.replace(
        ja.cfg, compute_dtype=jnp.float32, **over))
    ta = dataclasses.replace(ta, cfg=dataclasses.replace(
        ta.cfg, compute_dtype=torch.float32, **over))
    jp = jax.jit(ja.init)(jax.random.PRNGKey(1))
    tp = params_from_jax(ta.cfg, jax.tree.map(np.asarray, jp))
    b = _batches(ja, 1, batch=1, seq=1024)[0]
    b["labels"][0, :100] = -100
    (want, _), jg = jax.jit(jax.value_and_grad(ja.loss_fn, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    loss, _, grads = loss_and_grads(ta.loss_fn, tp, _t(b), None)
    np.testing.assert_allclose(float(loss), float(want), **F32)
    np.testing.assert_allclose(grads["embed"]["embedding"].numpy(),
                               np.asarray(jg["embed"]["embedding"]), **F32)


def _schedules(lr=2e-3, steps=4):
    return (jsched.warmup_hold_decay(lr, steps + 1, 1, 1),
            tsched.warmup_hold_decay(lr, steps + 1, 1, 1))


def _optimizers(name):
    jsch, tsch = _schedules()
    return {"lans": (jlans(jsch), tlans(tsch)),
            "fused_lans": (jfused_lans(jsch), tfused_lans(tsch)),
            "lamb": (jlamb(jsch), tlamb(tsch)),
            "adamw": (jadamw(jsch), tadamw(tsch))}[name]


@pytest.mark.parametrize("optimizer", ["lans", "fused_lans", "lamb", "adamw"])
@pytest.mark.parametrize("name", ["gemma2-2b", "qwen2.5-14b"])
def test_train_step_trajectory_matches_jax(name, optimizer):
    """4 steps of build_train_step on both packages from the same params
    and batches, fp32 policy and compute."""
    ja, jp, ta, tp = _pair(name)
    jtx, ttx = _optimizers(optimizer)
    batches = _batches(ja, 4, batch=4)
    mesh = make_local_mesh(data=1, model=1)
    jstep, jinit, specs_for = jbuild(ja.loss_fn, jtx, mesh,
                                     param_init_fn=lambda _: jp,
                                     policy="fp32")
    jparams, jstate = jinit(None)
    tstep, tinit = tbuild(ta.loss_fn, ttx, param_init_fn=lambda _: tp,
                          policy="fp32")
    tparams, tstate = tinit(None)
    jl, tl, step = [], [], None
    with mesh:
        for b in batches:
            jb = {k: jnp.asarray(v) for k, v in b.items()}
            if step is None:
                # the JAX package's sharding specs take no fused state:
                # its fused step is jitted without them
                step = (jax.jit(jstep) if optimizer == "fused_lans" else
                        jit_train_step(jstep, mesh,
                                       *specs_for(jparams, jstate), jb))
            jparams, jstate, jm = step(jparams, jstate, jb)
            jl.append(float(jm["loss"]))
            tparams, tstate, tm = tstep(tparams, tstate, _t(b))
            tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-3)
    assert tl[-1] != tl[0]


def test_fused_mixed_lans_matches_generic_wrapper_on_a_decoder():
    """bf16 policy on reduced gemma2-2b: build_train_step with
    fused_mixed_lans (K1, K2, K4; plain versions here) against
    mixed_precision(lans), 3 steps, fp32 moments on both: the first loss
    equal, later losses within 1e-4 relative, fp32 masters within 1e-6
    and bf16 params within one bf16 ulp (test_torch_train.py's
    tolerances for the same comparison on BERT)."""
    from repro_torch.precision import fused_mixed_lans, get_policy
    _, _, ta, tp = _pair("gemma2-2b")
    pol = get_policy("bf16")
    ta = dataclasses.replace(ta, cfg=pol.apply_to_cfg(ta.cfg))
    batches = _batches(ta, 3)
    out = []
    for tx in (tlans(1e-3), fused_mixed_lans(1e-3, pol)):
        step, init = tbuild(ta.loss_fn, tx, param_init_fn=lambda _: tp,
                            policy=pol)
        params, state = init(None)
        losses = []
        for b in batches:
            params, state, m = step(params, state, _t(b))
            losses.append(float(m["loss"]))
        out.append((losses, params, state))
    (l_gen, p_gen, s_gen), (l_fus, p_fus, s_fus) = out
    assert l_gen[0] == l_fus[0]
    np.testing.assert_allclose(l_fus, l_gen, rtol=1e-4)
    for (p, a), (_, b), (_, ma), (_, mb) in zip(
            tree_items(p_gen), tree_items(p_fus), tree_items(s_gen.master),
            tree_items(s_fus.master)):
        assert a.dtype == b.dtype, p
        if b.dtype == torch.bfloat16:
            np.testing.assert_allclose(ma.numpy(), mb.numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=p)
            np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                       rtol=2 ** -7, atol=1e-6, err_msg=p)
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=p)


@pytest.mark.parametrize("name", ["qwen2.5-14b", "chameleon-34b"])
def test_lm_batches_are_byte_equal(name):
    """make_data's decoder streams equal the JAX launcher's byte for
    byte: tokens and labels, or (chameleon) embeddings and labels."""
    ja, ta = jreduced(name), tconfigs.reduced_arch(name)
    jit = jmake_data(ja, batch=4, seq=64, seed=3)
    tit = ttrain.make_data(ta, batch=4, seq=64, seed=3)
    for _ in range(3):
        jb, tb = next(jit), next(tit)
        assert jb.keys() == tb.keys()
        for k in jb:
            assert jb[k].dtype == tb[k].dtype
            assert jb[k].tobytes() == tb[k].tobytes(), k


def test_cli_trains_a_decoder_on_cpu(monkeypatch):
    """The training CLI on reduced qwen2.5-14b: 3 steps with finite
    losses; --reduced clamps --seq to the arch's max_seq (256)."""
    seqs = []
    make = ttrain.make_data

    def spy(arch, *, batch, seq, **kw):
        seqs.append(seq)
        return make(arch, batch=batch, seq=seq, **kw)

    monkeypatch.setattr(ttrain, "make_data", spy)
    with contextlib.redirect_stdout(io.StringIO()):
        summary = ttrain.main(["--device", "cpu", "--arch", "qwen2.5-14b",
                               "--steps", "3", "--batch", "2", "--seq",
                               "1024"])
    assert seqs == [256]
    assert len(summary["losses"]) == 3
    assert all(np.isfinite(summary["losses"]))


@pytest.mark.parametrize("name", ["qwen2.5-14b-untied", "chameleon-34b",
                                  "qwen2.5-32b"])
def test_bridge_carries_the_decoder_trees(name):
    """params_from_jax on an untied head (lm_head), QK-norm scales and
    bf16 params (the dtype the full qwen2.5-32b and chameleon-34b configs
    set): keys, shapes, dtypes and values kept; a tree without the head
    the config asks for is refused."""
    base = name.replace("-untied", "")
    ja, ta = jreduced(base), tconfigs.reduced_arch(base)
    jover, tover = {}, {}
    if name.endswith("-untied"):
        jover["tie_embeddings"] = tover["tie_embeddings"] = False
    if name != "qwen2.5-14b-untied":     # the full config's param dtype
        jover["param_dtype"] = jnp.bfloat16
        tover["param_dtype"] = torch.bfloat16
    jcfg = dataclasses.replace(ja.cfg, **jover)
    tcfg = dataclasses.replace(ta.cfg, **tover)
    jp = jax.tree.map(np.asarray, jdec.decoder_init(jax.random.PRNGKey(2),
                                                    jcfg))
    tp = params_from_jax(tcfg, jp)
    with torch.device("meta"):
        want = tdec.decoder_init(None, tcfg)
    assert ([(p, t.shape, t.dtype) for p, t in tree_items(tp)]
            == [(p, t.shape, t.dtype) for p, t in tree_items(want)])
    for (path, t), j in zip(tree_items(tp), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32),
                                      err_msg=path)
    if name.endswith("-untied"):
        assert tp["lm_head"]["kernel"].shape == (tcfg.d_model, tcfg.vocab)
        del jp["lm_head"]
        with pytest.raises(ValueError, match="lm_head"):
            params_from_jax(tcfg, jp)
    if name == "chameleon-34b":
        assert tp["slot0"]["mixer"]["q_norm"]["scale"].shape == (
            tcfg.n_periods, tcfg.resolved_head_dim)
    if "param_dtype" in tover:
        assert tp["slot0"]["ffn"]["up"]["kernel"].dtype == torch.bfloat16


def _quickstart():
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_trains_on_cpu():
    with contextlib.redirect_stdout(io.StringIO()) as out:
        losses = _quickstart().main(["--device", "cpu", "--steps", "3"])
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert out.getvalue().strip().endswith("quickstart OK")


def test_quickstart_from_jax_params_matches_jax_quickstart():
    """The port's quickstart started from examples/quickstart.py's initial
    params (carried over by the bridge) gives that recipe's first 3
    losses: the JAX recipe is repeated here for 3 steps (reduced
    qwen2.5-14b, LANS, warmup-hold-decay, worker 0 of 4)."""
    from repro.configs import reduced_arch
    arch = reduced_arch("qwen2.5-14b")
    params = arch.init(jax.random.PRNGKey(0))
    schedule = jsched.warmup_hold_decay(eta=3e-3, total_steps=31,
                                        warmup_steps=6, hold_steps=10)
    tx = jlans(schedule)
    opt_state = tx.init(params)
    corpus = JCorpus(vocab=arch.cfg.vocab, num_docs=1024, doc_len=256)
    data = jlm(corpus, JShard(num_samples=1024, num_workers=4, worker=0),
               per_worker_batch=8, seq_len=64)

    @jax.jit
    def train_step(params, opt_state, batch):
        (loss, _), grads = jax.value_and_grad(
            arch.loss_fn, has_aux=True)(params, batch)
        grads = jax.tree.map(lambda g: g.astype(jnp.float32), grads)
        updates, opt_state = tx.update(grads, opt_state, params)
        return japply(params, updates), opt_state, loss

    want, p = [], params
    for _ in range(3):
        batch = {k: jnp.asarray(v) for k, v in next(data).items()}
        p, opt_state, loss = train_step(p, opt_state, batch)
        want.append(float(loss))
    tp = params_from_jax(tconfigs.reduced_arch("qwen2.5-14b").cfg,
                         jax.tree.map(np.asarray, params))
    with contextlib.redirect_stdout(io.StringIO()):
        got = _quickstart().main(["--device", "cpu", "--steps", "3"],
                                 params=tp)
    np.testing.assert_allclose(got, want, rtol=3e-2)


@pytest.mark.parametrize("caller_keeps", [False, True])
def test_tree_consume_frees_each_leaf_once_used(caller_keeps):
    """What keeps a full-size train step's peak down: tree_consume gives
    each leaf up once fn has used it, so where the caller handed over its
    only reference (the train step's gradients and updates) the leaves
    before the current one are already freed; a caller that keeps its
    tree gets it back whole."""
    import weakref
    from repro_torch.core.optim.base import tree_consume
    tree = {"a": torch.ones(2), "b": {"c": torch.ones(2) * 2,
                                      "d": torch.ones(2) * 3}}
    refs = [weakref.ref(tree["a"]), weakref.ref(tree["b"]["c"]),
            weakref.ref(tree["b"]["d"])]
    seen = []

    def fn(x, y):
        seen.append([r() is not None for r in refs])
        return x * y

    box = [tree]
    if not caller_keeps:
        del tree
    out = tree_consume(fn, box.pop(), {"a": 10, "b": {"c": 10, "d": 10}})
    assert out["a"].tolist() == [10, 10] and out["b"]["d"].tolist() == [30,
                                                                       30]
    if caller_keeps:
        assert seen == [[True] * 3] * 3
        assert sorted(tree) == ["a", "b"] and sorted(tree["b"]) == ["c", "d"]
    else:
        assert seen == [[True, True, True], [False, True, True],
                        [False, False, True]]


@pytest.mark.parametrize("optimizer", ["lans", "fused_lans",
                                       "fused_mixed_lans"])
def test_train_step_leaves_no_reference_cycle(optimizer):
    """With the collector off, the params and optimizer state a step was
    given are freed as soon as the caller drops them: nothing of the
    step (a recursive closure, an optimizer's closure over its old state)
    keeps them in a reference cycle, which at full size would hold a
    whole state on the card until the collector ran."""
    import gc
    import weakref
    from repro_torch.core.optim.base import tree_leaves
    from repro_torch.precision import fused_mixed_lans, get_policy
    _, _, ta, tp = _pair("gemma2-2b")
    policy = get_policy("bf16" if optimizer == "fused_mixed_lans"
                        else "fp32")
    ta = dataclasses.replace(ta, cfg=policy.apply_to_cfg(ta.cfg))
    tx = {"lans": lambda: tlans(1e-3), "fused_lans": lambda: tfused_lans(1e-3),
          "fused_mixed_lans": lambda: fused_mixed_lans(1e-3, policy)}[
        optimizer]()
    step, init = tbuild(ta.loss_fn, tx, param_init_fn=lambda _: tp,
                        policy=policy)
    b = _t(_batches(ta, 1)[0])
    params, state = init(None)
    params, state, _ = step(params, state, b)   # own tensors from here on
    gc.collect()
    gc.disable()
    try:
        refs = [weakref.ref(t) for t in tree_leaves(params)]
        refs += [weakref.ref(t) for s in (state if isinstance(state, tuple)
                                          else (state,))
                 for t in tree_leaves(getattr(s, "mu", {}))]
        assert refs
        new = step(params, state, b)
        del params, state
        assert not [r for r in refs if r() is not None]
        del new
    finally:
        gc.enable()


def test_first_train_step_leaves_nothing_for_the_collector():
    """In a fresh process, with the collector off, the params a first
    training step was given are freed once the caller drops them: the
    first checkpointed call would otherwise import torch._dynamo with the
    step's frames on the stack and keep them (and the params) alive."""
    import os
    import subprocess
    import sys
    code = """
import gc, torch
from torch.multiprocessing.reductions import StorageWeakRef
from repro_torch.configs import reduced_arch
from repro_torch.core.optim import lans
from repro_torch.core.optim.base import tree_leaves
from repro_torch.distributed.steps import build_train_step
from repro_torch.launch.train import make_data
gc.disable()
arch = reduced_arch("gemma2-2b")
step, init = build_train_step(arch.loss_fn, lans(1e-3),
                              param_init_fn=arch.init)
params, state = init(torch.Generator().manual_seed(0))
refs = [StorageWeakRef(t.untyped_storage()) for t in tree_leaves(params)]
b = {k: torch.from_numpy(v) for k, v in
     next(make_data(arch, batch=2, seq=16)).items()}
new = step(params, state, b)
del params, state
print(sum(not r.expired() for r in refs))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "0"
