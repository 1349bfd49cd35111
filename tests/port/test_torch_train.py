"""The port's training loop against the JAX package: build_train_step
trajectories on reduced bert-large ({LANS, LAMB, AdamW} x {hold, linear}
x {fp32, bf16}), the fused routes against the unfused ones,
the fp16 skip-and-halve path, microbatch averaging, the data pipeline
(byte-equal batches), checkpoints that cross frameworks, the metrics
logger and the training CLI on the CPU.

Tolerances: fp32-policy trajectories (fp32 compute on both sides) agree
to 1e-4 relative over 5 steps (two frameworks' summation orders, fed
back through 5 updates); bf16-policy ones (bf16 params and compute on
both sides) to 3e-2 relative, since bf16 matmuls round at other places
in XLA and PyTorch. Scale bookkeeping and the skipped step are exact.
"""
import contextlib
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import reduced_arch as jreduced
from repro.core import schedules as jsched
from repro.core.optim import adamw as jadamw
from repro.core.optim import apply_updates as japply
from repro.core.optim import lamb as jlamb
from repro.core.optim import lans as jlans
from repro.data.corpus import SyntheticCorpus as JCorpus
from repro.data.corpus import mlm_batch_iterator as jmlm
from repro.data.sharding import ShardSpec as JShard
from repro.distributed.steps import build_train_step as jbuild
from repro.distributed.steps import jit_train_step
from repro.launch.mesh import make_local_mesh
from repro.metrics import MetricsLogger as JLogger
from repro.precision import get_policy as jpolicy
from repro.precision import loss_scale_value as jscale
from repro.precision import mixed_precision as jmixed
from repro.precision import overflow_count as jovf
from repro_torch import checkpoint as tckpt
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.core import schedules as tsched
from repro_torch.core.optim import adamw as tadamw
from repro_torch.core.optim import apply_updates as tapply
from repro_torch.core.optim import fused_lamb as tfused_lamb
from repro_torch.core.optim import fused_lans as tfused_lans
from repro_torch.core.optim import lamb as tlamb
from repro_torch.core.optim import lans as tlans
from repro_torch.core.optim.base import tree_items
from repro_torch.data.corpus import SyntheticCorpus as TCorpus
from repro_torch.data.corpus import mlm_batch_iterator as tmlm
from repro_torch.data.sharding import ShardSpec as TShard
from repro_torch.distributed.steps import build_train_step as tbuild
from repro_torch.launch import train as ttrain
from repro_torch.metrics import MetricsLogger as TLogger
from repro_torch.metrics import read_metrics
from repro_torch.precision import DynamicLossScale as TDynamic
from repro_torch.precision import get_policy as tpolicy
from repro_torch.precision import loss_scale_value as tscale
from repro_torch.precision import mixed_precision as tmixed
from repro_torch.precision import overflow_count as tovf

STEPS = 5


def _batches(vocab, n, *, batch=4, seq=32, seed=0):
    corpus = JCorpus(vocab=vocab, num_docs=256, doc_len=256, seed=seed)
    it = jmlm(corpus, JShard(256, 1, 0, seed), per_worker_batch=batch,
              seq_len=seq, seed=seed)
    return [next(it) for _ in range(n)]


@pytest.fixture(scope="module")
def reduced_pair():
    ja = jreduced("bert-large")
    ta = tconfigs.reduced_arch("bert-large")
    jp = jax.jit(ja.init)(jax.random.PRNGKey(0))
    tp = params_from_jax(ta.cfg, jax.tree.map(np.asarray, jp))
    return ja, jp, ta, tp, _batches(ja.cfg.vocab, STEPS)


def _schedules(kind, lr=2e-3):
    if kind == "hold":
        return (jsched.warmup_hold_decay(lr, STEPS + 1, 1, 1),
                tsched.warmup_hold_decay(lr, STEPS + 1, 1, 1))
    return (jsched.warmup_linear_decay(lr, STEPS + 1, 1),
            tsched.warmup_linear_decay(lr, STEPS + 1, 1))


def _optimizers(name, schedule, precision):
    """The JAX and port optimizers as the launchers build them: only lans
    stores its moments in the policy's moment dtype. All train at the
    LANS rate of 2e-3 but bf16 AdamW, which trains at BERT's own AdamW
    rate, 1e-4 (Devlin et al.): at 2e-3 its bf16 trajectories part on
    rounding noise (see test_adamw_bf16_moves_key_bias_on_rounding_noise)."""
    jpol, tpol = jpolicy(precision), tpolicy(precision)
    if name == "lans":
        jsch, tsch = _schedules(schedule)
        return (jlans(jsch, mu_dtype=jpol.moment_dtype),
                tlans(tsch, mu_dtype=tpol.moment_dtype))
    if name == "lamb":
        jsch, tsch = _schedules(schedule)
        return jlamb(jsch), tlamb(tsch)
    jsch, tsch = _schedules(schedule,
                            lr=1e-4 if precision == "bf16" else 2e-3)
    return jadamw(jsch), tadamw(tsch)


def _run_pair(reduced_pair, precision, jtx, ttx, n_steps):
    """n_steps of build_train_step on both packages from the same params
    and batches, compute in the policy's dtype (fp32 for "fp32"). Returns
    the losses, the last metrics and params of each side."""
    ja, jp, ta, tp, batches = reduced_pair
    jpol, tpol = jpolicy(precision), tpolicy(precision)
    cd = ((jnp.float32, torch.float32) if precision == "fp32"
          else (jnp.bfloat16, torch.bfloat16))
    ja = dataclasses.replace(ja, cfg=dataclasses.replace(
        ja.cfg, compute_dtype=cd[0]))
    ta = dataclasses.replace(ta, cfg=dataclasses.replace(
        ta.cfg, compute_dtype=cd[1]))
    mesh = make_local_mesh(data=1, model=1)
    jstep, jinit, specs_for = jbuild(ja.loss_fn, jtx, mesh,
                                     param_init_fn=lambda _: jp, policy=jpol)
    jparams, jtx_state = jinit(None)
    tstep, tinit = tbuild(ta.loss_fn, ttx, param_init_fn=lambda _: tp,
                          policy=tpol)
    tparams, tstate = tinit(None)
    jl, tl = [], []
    step = None
    with mesh:
        for b in batches[:n_steps]:
            jb = {k: jnp.asarray(v) for k, v in b.items()}
            if step is None:
                pspec, ospec = specs_for(jparams, jtx_state)
                step = jit_train_step(jstep, mesh, pspec, ospec, jb)
            jparams, jtx_state, jm = step(jparams, jtx_state, jb)
            jl.append(float(jm["loss"]))
            tparams, tstate, tm = tstep(tparams, tstate,
                                        {k: torch.from_numpy(v)
                                         for k, v in b.items()})
            tl.append(float(tm["loss"]))
    return jl, tl, jm, tm, jparams, tparams


@pytest.mark.parametrize("optimizer", ["lans", "lamb", "adamw"])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("schedule", ["hold", "linear"])
def test_train_step_trajectory_matches_jax(reduced_pair, schedule, precision,
                                           optimizer):
    jtx, ttx = _optimizers(optimizer, schedule, precision)
    jl, tl, jm, tm, _, tparams = _run_pair(reduced_pair, precision, jtx, ttx,
                                           STEPS)
    tol = 1e-4 if precision == "fp32" else 3e-2
    np.testing.assert_allclose(tl, jl, rtol=tol)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=tol * 10)
    if precision == "bf16":
        assert float(tm["loss_scale"]) == float(jm["loss_scale"]) == 1.0
        assert int(tm["overflow_count"]) == int(jm["overflow_count"]) == 0
        assert tparams["layers"]["mlp"]["up"]["kernel"].dtype == torch.bfloat16


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_adamw_bf16_moves_key_bias_on_rounding_noise(reduced_pair,
                                                     precision):
    """Why bf16 AdamW's trajectories are compared at 1e-4: the attention
    key bias has a true gradient of 0 (it adds one constant to every
    logit of a query row), so its gradient is rounding noise. AdamW scales each
    element to about +-lr whatever its size, above eps = 1e-6. With bf16
    compute the noise is above eps, and after one step at 2e-3 the key
    bias has moved by most of a step in BOTH packages, in directions that
    agree no better than a coin; with fp32 compute it barely moves. The
    query bias, whose gradient is real, moves by a full step in the same
    direction on both sides. A behaviour of the reference that the port
    copies (ROADMAP Queue 3)."""
    jsch, tsch = _schedules("hold")
    _, _, _, _, j1, t1 = _run_pair(reduced_pair, precision, jadamw(jsch),
                                   tadamw(tsch), 1)
    jp = reduced_pair[1]
    for name, moves in (("wk", precision == "bf16"), ("wq", True)):
        j0 = np.asarray(jp["layers"]["attn"][name]["bias"], np.float32)
        dj = np.asarray(j1["layers"]["attn"][name]["bias"], np.float32) - j0
        dt = t1["layers"]["attn"][name]["bias"].float().numpy() - j0
        for d in (dj, dt):
            step = np.median(np.abs(d)) / 2e-3
            assert (step > 0.5) if moves else (step < 0.01), (name, step)
        agree = np.mean(np.sign(dj) == np.sign(dt))
        if name == "wq":
            assert agree > 0.95, agree
        elif precision == "bf16":
            assert agree < 0.75, agree


def _fused_vs_unfused(ta, tp, batches, unfused, fused):
    out = []
    for tx in (unfused, fused):
        step, init = tbuild(ta.loss_fn, tx, param_init_fn=lambda _: tp,
                            policy="fp32")
        params, state = init(None)
        losses = []
        for b in batches[:3]:
            params, state, m = step(params, state, {
                k: torch.from_numpy(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
        out.append((losses, params))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-5)
    for (p, a), (_, b) in zip(tree_items(out[0][1]), tree_items(out[1][1])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=p)


def test_fused_lans_train_step_matches_unfused(reduced_pair):
    """build_train_step with fused_lans (the kernel path, plain versions
    here) against the same step with lans: fp32, 3 steps."""
    _, _, ta, tp, batches = reduced_pair
    _fused_vs_unfused(ta, tp, batches, tlans(1e-3), tfused_lans(1e-3))


def test_fused_lamb_train_step_matches_unfused(reduced_pair):
    """build_train_step with fused_lamb (K1 for the clip, K5, K6; plain
    versions here) against the same step with lamb: fp32, 3 steps."""
    _, _, ta, tp, batches = reduced_pair
    _fused_vs_unfused(ta, tp, batches, tlamb(1e-3), tfused_lamb(1e-3))


def test_fused_mixed_lans_train_step_matches_generic_wrapper(reduced_pair):
    """build_train_step with fused_mixed_lans (K1, K2, K4; plain versions
    here) against the same step with mixed_precision(lans) on the bf16
    policy, fp32 moments on both: 3 steps. The fused transform is used
    as it is, not wrapped again (the JAX builder wraps it a second time;
    ROADMAP Queue 3). Step 1 sees the same params and batch on both
    routes, so its loss is equal; fp32 masters agree to 1e-6 (fused vs
    unfused arithmetic; 1.5e-8 seen), the bf16 params to one bf16 ulp,
    should a master's difference cross a rounding edge (both routes
    add `cast(master) - params` to the bf16 params, so they hold the
    cast only to rounding), and the later losses, computed on those bf16
    params, to 1e-4 relative."""
    from repro_torch.precision import fused_mixed_lans as tfused_mixed
    from repro_torch.precision.fused import FusedMixedState
    _, _, ta, tp, batches = reduced_pair
    pol = tpolicy("bf16")
    ta = dataclasses.replace(ta, cfg=pol.apply_to_cfg(ta.cfg))
    out = []
    for tx in (tlans(1e-3), tfused_mixed(1e-3, pol)):
        step, init = tbuild(ta.loss_fn, tx, param_init_fn=lambda _: tp,
                            policy=pol)
        params, state = init(None)
        losses = []
        for b in batches[:3]:
            params, state, m = step(params, state, {
                k: torch.from_numpy(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
        assert float(m["loss_scale"]) == 1.0
        assert int(m["overflow_count"]) == 0
        out.append((losses, params, state))
    (l_gen, p_gen, s_gen), (l_fus, p_fus, s_fus) = out
    assert isinstance(s_fus, FusedMixedState)
    assert l_gen[0] == l_fus[0]
    np.testing.assert_allclose(l_fus, l_gen, rtol=1e-4)
    assert int(s_fus.count) == 3
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


def test_microbatches_average_grads(reduced_pair):
    """microbatches=2 averages the two halves' fp32 gradients and losses."""
    from repro_torch.distributed.steps import loss_and_grads
    _, _, ta, tp, batches = reduced_pair
    b = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    step, init = tbuild(ta.loss_fn, tlans(1e-3), microbatches=2,
                        param_init_fn=lambda _: tp)
    params, state = init(None)
    _, _, m = step(params, state, b)
    halves = [loss_and_grads(ta.loss_fn, tp, {k: v[i * 2:(i + 1) * 2]
                                              for k, v in b.items()}, None)
              for i in range(2)]
    np.testing.assert_allclose(float(m["loss"]),
                               float(halves[0][0] + halves[1][0]) / 2,
                               rtol=1e-6)
    gn = torch.sqrt(sum(torch.sum(((g0 + g1) / 2) ** 2) for (_, g0), (_, g1)
                        in zip(tree_items(halves[0][2]),
                               tree_items(halves[1][2]))))
    np.testing.assert_allclose(float(m["grad_norm"]), float(gn), rtol=1e-5)
    with pytest.raises(ValueError, match="microbatches"):
        tbuild(ta.loss_fn, tlans(1e-3), microbatches=3)[0](
            params, state, b)


def _tiny():
    return {"layer": {"kernel": np.full((8, 4), 0.5, np.float32),
                      "bias": np.zeros((4,), np.float32)},
            "ln": {"scale": np.ones((4,), np.float32),
                   "bias": np.zeros((4,), np.float32)}}


def test_fp16_overflow_skips_step_and_halves_scale():
    """tests/test_precision.py's seeded overflow, on both packages: one
    inf leaf skips the whole step (params exactly unchanged), halves the
    scale and counts one overflow; a clean step then trains at the
    reduced scale."""
    jpol, tpol = jpolicy("fp16_mixed"), tpolicy("fp16_mixed")
    jlp = jpol.cast_params(jax.tree.map(jnp.asarray, _tiny()))
    tlp = tpol.cast_params({k: {kk: torch.from_numpy(vv) for kk, vv in
                                v.items()} for k, v in _tiny().items()})
    jtx, ttx = jmixed(jlans(1e-2), jpol), tmixed(tlans(1e-2), tpol)
    js, ts = jtx.init(jlp), ttx.init(tlp)
    assert float(tscale(ts)) == float(jscale(js)) == 2.0 ** 16

    def grads(tree, fill, mod):
        return {k: {kk: mod.full(vv.shape, fill, dtype=vv.dtype)
                    for kk, vv in v.items()} for k, v in tree.items()}

    jbad, tbad = grads(jlp, 1.0, jnp), grads(tlp, 1.0, torch)
    jbad["layer"]["kernel"] = jbad["layer"]["kernel"].at[0, 0].set(jnp.inf)
    tbad["layer"]["kernel"][0, 0] = float("inf")
    ju, js = jtx.update(jbad, js, jlp)
    tu, ts = ttx.update(tbad, ts, tlp)
    jlp2, tlp2 = japply(jlp, ju), tapply(tlp, tu)
    assert float(tscale(ts)) == float(jscale(js)) == 2.0 ** 15
    assert int(tovf(ts)) == int(jovf(js)) == 1
    for (p, a), (_, b) in zip(tree_items(tlp), tree_items(tlp2)):
        assert torch.equal(a, b), p
    s = float(tscale(ts))
    ju, js = jtx.update(grads(jlp2, s, jnp), js, jlp2)
    tu, ts = ttx.update(grads(tlp2, s, torch), ts, tlp2)
    jlp3, tlp3 = japply(jlp2, ju), tapply(tlp2, tu)
    assert int(tovf(ts)) == int(jovf(js)) == 1
    assert not torch.equal(tlp3["layer"]["kernel"], tlp2["layer"]["kernel"])
    np.testing.assert_allclose(
        tlp3["layer"]["kernel"].float().numpy(),
        np.asarray(jlp3["layer"]["kernel"], np.float32), rtol=1e-3)


def test_train_step_fp16_overflow_is_skipped(reduced_pair):
    """build_train_step with fp16 and a loss scale so large that the fp16
    gradients overflow: the step is skipped and the scale halved."""
    _, _, ta, tp, batches = reduced_pair
    pol = tpolicy("fp16")
    ta = dataclasses.replace(ta, cfg=pol.apply_to_cfg(ta.cfg))
    step, init = tbuild(ta.loss_fn, tlans(1e-3), param_init_fn=lambda _: tp,
                        policy=pol, loss_scale=TDynamic(init_scale=2.0 ** 60))
    params, state = init(None)
    b = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    new, state, m = step(params, state, b)
    assert not bool(m["grads_finite"])
    assert float(m["loss_scale"]) == 2.0 ** 59
    assert int(m["overflow_count"]) == 1
    for (p, a), (_, c) in zip(tree_items(params), tree_items(new)):
        assert torch.equal(a, c), p
    assert np.isfinite(float(m["loss"]))


def test_mlm_batches_are_byte_equal():
    jc = JCorpus(vocab=30522, num_docs=512, doc_len=258, seed=3)
    tc = TCorpus(vocab=30522, num_docs=512, doc_len=258, seed=3)
    jit = jmlm(jc, JShard(512, 4, 1, 3), per_worker_batch=8, seq_len=128,
               seed=3)
    tit = tmlm(tc, TShard(512, 4, 1, 3), per_worker_batch=8, seq_len=128,
               seed=3)
    for _ in range(20):      # crosses an epoch boundary (128 / 8 = 16)
        jb, tb = next(jit), next(tit)
        assert jb.keys() == tb.keys()
        for k in jb:
            assert jb[k].dtype == tb[k].dtype
            assert jb[k].tobytes() == tb[k].tobytes(), k


def test_checkpoints_cross_frameworks(tmp_path, reduced_pair):
    ja, jp, ta, tp, _ = reduced_pair
    tp16 = tpolicy("bf16").cast_params(tp)
    tckpt.save(str(tmp_path / "t"), 7, tp16, metadata={"from": "torch"})
    assert tckpt.latest_step(str(tmp_path / "t")) == 7
    back = tckpt.restore(str(tmp_path / "t"), 7, tp16)
    for (p, a), (_, b) in zip(tree_items(tp16), tree_items(back)):
        assert a.dtype == b.dtype and torch.equal(a, b), p
    jback = jckpt.restore(str(tmp_path / "t"), 7, jp)
    for (p, a), b in zip(tree_items(tp16), jax.tree.leaves(jback)):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32), err_msg=p)
    jckpt.save(str(tmp_path / "j"), 3, jp)
    tback = tckpt.restore(str(tmp_path / "j"), 3, tp)
    for (p, a), (_, b) in zip(tree_items(tp), tree_items(tback)):
        assert torch.equal(a, b), p
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore(str(tmp_path / "j"), 3,
                      {**tp, "mlm_bias": torch.zeros(3)})


def test_metrics_logger_window_matches_jax(tmp_path):
    jl, tl = JLogger(None, window=3), TLogger(str(tmp_path / "m.jsonl"),
                                              window=3)
    assert tl.smoothed_loss is None
    for i, loss in enumerate([4.0, 3.0, 2.5, 2.0, torch.tensor(1.5)]):
        jl.log(i, loss=float(loss))
        tl.log(i, loss=loss, lr=torch.tensor(0.1))
    assert tl.smoothed_loss == jl.smoothed_loss == pytest.approx(2.0)
    tl.close()
    recs = list(read_metrics(str(tmp_path / "m.jsonl")))
    assert [r["step"] for r in recs] == list(range(5))
    assert recs[-1]["loss"] == 1.5 and recs[-1]["lr"] == pytest.approx(0.1)


def test_cli_trains_on_cpu(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        summary = ttrain.main([
            "--device", "cpu", "--arch", "bert-large", "--steps", "3",
            "--batch", "4", "--seq", "32", "--ckpt-dir",
            str(tmp_path / "ck"), "--metrics", str(tmp_path / "m.jsonl")])
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    assert set(last) == {"first_loss", "final_loss", "steps"}
    assert last["steps"] == 3 == len(summary["losses"])
    assert last["final_loss"] == summary["final_loss"]
    assert all(np.isfinite(summary["losses"]))
    assert summary["mean_step_s"] > 0 and summary["device"] == "cpu"
    assert tckpt.latest_step(str(tmp_path / "ck")) == 3
    assert len(list(read_metrics(str(tmp_path / "m.jsonl")))) == 3


def test_cli_fp16_reports_loss_scale():
    with contextlib.redirect_stdout(io.StringIO()):
        summary = ttrain.main(["--device", "cpu", "--steps", "2", "--batch",
                               "2", "--seq", "32", "--precision", "fp16"])
    assert np.isfinite(summary["final_loss"])
    assert summary["loss_scale"] in (2.0 ** 16, 2.0 ** 15, 2.0 ** 14)
    assert summary["overflow_count"] == int(
        np.log2(2.0 ** 16 / summary["loss_scale"]))


@pytest.mark.parametrize("argv", [["--optimizer", "lamb"],
                                  ["--optimizer", "adamw"],
                                  ["--optimizer", "lamb", "--precision",
                                   "bf16"]])
def test_cli_optimizers_train_on_cpu(argv):
    with contextlib.redirect_stdout(io.StringIO()):
        summary = ttrain.main(["--device", "cpu", "--steps", "2", "--batch",
                               "2", "--seq", "32", *argv])
    assert len(summary["losses"]) == 2
    assert all(np.isfinite(summary["losses"]))
    if "bf16" in argv:
        assert summary["loss_scale"] == 1.0
        assert summary["overflow_count"] == 0


def test_cli_defaults_to_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--steps", "1"])
