"""The port's LANS optimizers and the plain versions of kernels K1-K4
against the JAX package, on the same numpy inputs:

  * plain K1-K4 (repro_torch/kernels/lans.py) composed by ops.py against
    repro/kernels/ref.py (sq_norm_ref, lans_step_ref) and against the
    Pallas kernels behind repro.kernels.ops (fused_lans_step,
    fused_lans_mixed_step, interpret mode), over the cases chip_smoke.py
    runs on the card: g/x fp32 and bf16, step 1 and 4, lam 0 with trust
    off, a zero-gradient leaf, a NaN in g, lp copies in bf16 and fp16;
  * lans / fused_lans / fused_mixed_lans trajectories over 4 steps against
    the JAX transforms, the mixed ones through an overflow step;
  * the schedules and the pure-Python helpers.

Tolerance: 2e-5 (rtol and atol) with fp32 operands and 2e-2 with bf16
ones, as tests/test_kernels.py holds the Pallas kernels to their oracle
(fp32 arithmetic on both sides; rsqrt and summation order differ). The
4-step trajectories hold to 1e-5 in fp32 (1e-2 relative for the half
precision model copies, one ulp of fp16/bf16).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import schedules as jsched
from repro.core.optim import apply_updates as japply
from repro.core.optim import lans as jlans
from repro.core.optim.base import WeightDecayMask as JMask
from repro.core.optim.fused import fused_lans as jfused_lans
from repro.kernels import ops as jops
from repro.kernels import ref
from repro.precision import StaticLossScale as JStatic
from repro.precision import fused_mixed_lans as jfused_mixed
from repro.precision import get_policy as jpolicy
from repro.precision import mixed_precision as jmixed
from repro_torch.core import schedules as tsched
from repro_torch.core.optim import apply_updates as tapply
from repro_torch.core.optim import fused_lans as tfused_lans
from repro_torch.core.optim import lans as tlans
from repro_torch.core.optim.base import WeightDecayMask as TMask
from repro_torch.core.optim.base import bias_correction, tree_items
from repro_torch.kernels import lans as kl
from repro_torch.kernels import ops as tops
from repro_torch.precision import StaticLossScale as TStatic
from repro_torch.precision import fused_mixed_lans as tfused_mixed
from repro_torch.precision import get_policy as tpolicy
from repro_torch.precision import mixed_precision as tmixed

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
       torch.float16: jnp.float16}


def _np(t):
    return t.float().numpy() if torch.is_tensor(t) else np.asarray(
        t, np.float32)


def _jax_case(case, dtype):
    g, m, v, x = case
    return (jnp.asarray(_np(g), JDT[dtype]), jnp.asarray(_np(m)),
            jnp.asarray(_np(v)), jnp.asarray(_np(x), JDT[dtype]))


KINDS = [("normal", 0.01, True), ("normal", 0.0, False),
         ("zero_grad", 0.01, True), ("nan_grad", 0.01, True)]


@pytest.mark.parametrize("kind,lam,trust", KINDS)
@pytest.mark.parametrize("step", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 127, 32773])
def test_plain_step_matches_ref(n, dtype, step, kind, lam, trust):
    """K1-K3 plain, composed by ops.fused_lans_step, against the oracle."""
    case = kl.lans_case(n, dtype, kind=kind, seed=n + step)
    tol = F32 if dtype == torch.float32 else BF16
    np.testing.assert_allclose(
        float(tops.block_sq_norm(case[0])),
        float(ref.sq_norm_ref(_jax_case(case, dtype)[0])), rtol=1e-5)
    got = tops.fused_lans_step(*case, eta=0.02, step=step, lam=lam,
                               apply_trust=trust)
    want = ref.lans_step_ref(*_jax_case(case, dtype), eta=0.02, step=step,
                             lam=lam, apply_trust=trust)
    assert got.x.dtype == dtype and got.m.dtype == torch.float32
    for a, b in zip(got, want):
        assert np.isfinite(_np(a)).all()
        np.testing.assert_allclose(_np(a), _np(b), **tol)


@pytest.mark.parametrize("kind,lam,trust", [KINDS[0], KINDS[1], KINDS[3]])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_step_matches_pallas(dtype, kind, lam, trust):
    """ops.fused_lans_step against the Pallas pipeline (interpret mode),
    across a tile boundary of the TPU layout (32773 > 256 x 128)."""
    case = kl.lans_case(32773, dtype, kind=kind, seed=5)
    got = tops.fused_lans_step(*case, eta=0.02, step=4, lam=lam,
                               apply_trust=trust)
    want = jops.fused_lans_step(*_jax_case(case, dtype), eta=0.02, step=4,
                                lam=lam, apply_trust=trust)
    for a, b in zip(got, want):
        np.testing.assert_allclose(
            _np(a), _np(b), **(F32 if dtype == torch.float32 else BF16))


@pytest.mark.parametrize("lp", [torch.bfloat16, torch.float16])
def test_plain_mixed_step_matches_pallas(lp):
    """K4 plain (ops.fused_lans_mixed_step) against the Pallas cast
    kernel; its master equals the K3 step and its copy is the cast."""
    case = kl.lans_case(4099, torch.float32, seed=2)
    got = tops.fused_lans_mixed_step(*case, eta=0.01, step=1, lp_dtype=lp)
    want = jops.fused_lans_mixed_step(*_jax_case(case, torch.float32),
                                      eta=0.01, step=1, lp_dtype=JDT[lp])
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(_np(a), _np(b), **F32)
    assert got.x_lp.dtype == lp
    np.testing.assert_allclose(_np(got.x_lp), _np(want.x_lp), rtol=1e-2,
                               atol=1e-3)
    assert torch.equal(got.x_lp, got.x.to(lp))
    plain3 = tops.fused_lans_step(*case, eta=0.01, step=1)
    assert torch.equal(got.x, plain3.x)


def test_phase1_norms_layout_and_select_on_nan():
    """K2's norms are [r_sq, c_sq, x_sq, 0 x 5]; a NaN gradient block
    normalizes to 0 (select, not multiply), so nothing is NaN."""
    g, m, v, x = kl.lans_case(300, kind="nan_grad")
    scal = tops.lans_scalars(0.01, 1, beta1=0.9, beta2=0.999, lam=0.01,
                             apply_trust=True, device="cpu")
    kl.sq_norm(g, out=scal[5:6])
    assert torch.isnan(scal[5])
    m1, v1, norms = kl.lans_phase1(scal, g, m, v, x, beta1=0.9, beta2=0.999,
                                   eps=1e-6)
    assert torch.equal(norms[3:], torch.zeros(5))
    assert torch.isfinite(norms[:3]).all() and torch.isfinite(m1).all()
    np.testing.assert_allclose(float(norms[2]), float((x * x).sum()),
                               rtol=1e-6)
    np.testing.assert_allclose(_np(m1), 0.9 * _np(m), rtol=1e-6)


def test_scalars_bias_corrections_are_fp32():
    """bc = 1 - float32(beta) ** t in fp32, as the JAX wrappers build it."""
    for step in (1, 4, 1000):
        s = tops.lans_scalars(0.5, torch.tensor(step, dtype=torch.int32),
                              beta1=0.9, beta2=0.999, lam=0.01,
                              apply_trust=False, device="cpu")
        want = [1.0 - np.float32(0.9) ** np.float32(step),
                1.0 - np.float32(0.999) ** np.float32(step)]
        np.testing.assert_allclose(s[:2].numpy(), np.float32(want),
                                   rtol=1e-6)
        assert s[2] == 0.5 and s[4] == 0.0 and s[5] == 0.0
        np.testing.assert_array_equal(
            bias_correction(0.999, torch.tensor(step)).numpy(),
            s[1].numpy())


def test_scalar_rows_are_the_per_tensor_scalars():
    """A step's rows (built once for all tensors) equal the scalars one
    tensor's step would build, decay on or off, and each row is a
    contiguous 8-float operand."""
    step = torch.tensor(3, dtype=torch.int32)
    rows = tops.lans_scalar_rows(torch.tensor(0.25), step, [True, False,
                                                            True],
                                 beta1=0.9, beta2=0.999, lam=0.01,
                                 device="cpu")
    assert rows.shape == (3, 8)
    for row, decay in zip(rows.unbind(0), (True, False, True)):
        want = tops.lans_scalars(0.25, 3, beta1=0.9, beta2=0.999,
                                 lam=0.01 if decay else 0.0,
                                 apply_trust=decay, device="cpu")
        assert row.is_contiguous() and torch.equal(row, want)
    with pytest.raises(TypeError, match="scalars"):
        tops.fused_lans_step(*kl.lans_case(4), eta=0.1)


# --------------------------------------------------------------------------
# transforms over trees
# --------------------------------------------------------------------------

def _tree(rng):
    """A small params tree with a stacked block, an excluded bias, an LN
    scale (which the mask does NOT exclude, as in the reference) and an
    embedding."""
    return {"layers": {"w": rng.normal(size=(2, 6, 5)).astype(np.float32),
                       "bias": rng.normal(size=(2, 5)).astype(np.float32),
                       "attn_ln": {"scale": np.ones((2, 5), np.float32)}},
            "embed": rng.normal(size=(11, 6)).astype(np.float32) * 0.02}


def _grads(rng, tree, i):
    g = {k: _grads(rng, v, i) if isinstance(v, dict)
         else (rng.normal(size=v.shape) * (i + 1)).astype(np.float32)
         for k, v in tree.items()}
    return g


def _to_t(tree, dtype=None):
    return {k: _to_t(v, dtype) if isinstance(v, dict) else
            torch.from_numpy(np.array(v)).to(dtype or torch.float32)
            for k, v in tree.items()}


def _to_j(tree, dtype=jnp.float32):
    return {k: _to_j(v, dtype) if isinstance(v, dict) else
            jnp.asarray(v, dtype) for k, v in tree.items()}


def _assert_trees(t_tree, j_tree, **tol):
    import jax
    from repro.core.optim.base import tree_paths as jpaths
    jflat = dict(zip(jax.tree.leaves(jpaths(j_tree)),
                     jax.tree.leaves(j_tree)))
    for path, t in tree_items(t_tree):
        np.testing.assert_allclose(_np(t), np.asarray(jflat[path],
                                                      np.float32),
                                   err_msg=path, **tol)


def test_weight_decay_mask_is_the_reference_copy():
    paths = ["layers/attn_ln/scale", "embed_ln/scale", "layers/mlp/up/bias",
             "layers/attn/wq/kernel", "tok_embed/embedding", "mlm_bias",
             "layers/LayerNorm/x", "final_norm/scale", "a/scale_param"]
    assert [TMask()(p) for p in paths] == [JMask()(p) for p in paths]
    assert TMask()("layers/attn_ln/scale")   # decayed, as in the reference


@pytest.mark.parametrize("kind,switches", [
    ("lans", dict()), ("lans", dict(normalize_grads=False)),
    ("lans", dict(nesterov=False)), ("lans", dict(phi_clip=(0.1, 2.0))),
    ("fused_lans", dict())])
def test_lans_trajectory_matches_jax(kind, switches):
    """4 steps of the port's transform and the JAX one on the same params
    and gradients (warmup-hold-decay schedule); the ablation switches
    exist on the unfused transform only, as in the JAX package."""
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    grads = [_grads(rng, p0, i) for i in range(4)]
    grads[2]["layers"]["bias"][:] = 0.0            # a zero-gradient block
    jsch = jsched.warmup_hold_decay(1e-2, 10, 2, 3)
    tsch = tsched.warmup_hold_decay(1e-2, 10, 2, 3)
    jtx = (jlans(jsch, **switches) if kind == "lans" else jfused_lans(jsch))
    ttx = (tlans(tsch, **switches) if kind == "lans" else tfused_lans(tsch))
    jp, tp = _to_j(p0), _to_t(p0)
    js, ts = jtx.init(jp), ttx.init(tp)
    for g in grads:
        ju, js = jtx.update(_to_j(g), js, jp)
        jp = japply(jp, ju)
        tu, ts = ttx.update(_to_t(g), ts, tp)
        tp = tapply(tp, tu)
    _assert_trees(tp, jp, rtol=1e-5, atol=1e-6)


def test_lans_bf16_moments_match_jax():
    rng = np.random.default_rng(1)
    p0 = _tree(rng)
    jtx, ttx = (jlans(1e-2, mu_dtype=jnp.bfloat16),
                tlans(1e-2, mu_dtype=torch.bfloat16))
    jp, tp = _to_j(p0), _to_t(p0)
    js, ts = jtx.init(jp), ttx.init(tp)
    for i in range(3):
        g = _grads(rng, p0, i)
        ju, js = jtx.update(_to_j(g), js, jp)
        jp = japply(jp, ju)
        tu, ts = ttx.update(_to_t(g), ts, tp)
        tp = tapply(tp, tu)
    assert ts[0].mu["embed"].dtype == torch.bfloat16
    _assert_trees(tp, jp, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["mixed_lans", "fused_mixed_lans"])
def test_mixed_trajectory_with_overflow_matches_jax(kind):
    """fp16 model copy, fp32 masters, static scale 64; step 1 overflows
    and must be skipped identically (no moment update, no schedule tick),
    as tests/test_precision.py pins for the JAX package."""
    rng = np.random.default_rng(2)
    p0 = _tree(rng)
    jpol = jpolicy("fp16_mixed")
    tpol = tpolicy("fp16_mixed")
    import dataclasses
    jpol = dataclasses.replace(jpol, moment_dtype=jnp.float32)
    tpol = dataclasses.replace(tpol, moment_dtype=torch.float32)
    if kind == "mixed_lans":
        jtx = jmixed(jlans(1e-2), jpol, loss_scale=JStatic(64.0))
        ttx = tmixed(tlans(1e-2), tpol, loss_scale=TStatic(64.0))
    else:
        jtx = jfused_mixed(1e-2, jpol, loss_scale=JStatic(64.0))
        ttx = tfused_mixed(1e-2, tpol, loss_scale=TStatic(64.0))
    jp, tp = jpol.cast_params(_to_j(p0)), tpol.cast_params(_to_t(p0))
    assert tp["layers"]["w"].dtype == torch.float16
    assert tp["layers"]["attn_ln"]["scale"].dtype == torch.float32
    js, ts = jtx.init(jp), ttx.init(tp)
    for i in range(4):
        g = _grads(rng, p0, i)
        g = {k: v for k, v in g.items()}
        scaled = lambda tree: {k: scaled(v) if isinstance(v, dict)
                               else v * 64.0 for k, v in tree.items()}
        g = scaled(g)
        if i == 1:
            g["embed"][0, 0] = np.inf
        before = {p: t.clone() for p, t in tree_items(tp)}
        ju, js = jtx.update(_to_j(g), js, jp)
        jp = japply(jp, ju)
        tu, ts = ttx.update(_to_t(g), ts, tp)
        tp = tapply(tp, tu)
        if i == 1:
            for p, t in tree_items(tp):
                assert torch.equal(t, before[p]), p
    assert int(ts.loss_scale.overflow_count) == 1
    assert int(js.loss_scale.overflow_count) == 1
    _assert_trees(tp, jp, rtol=1e-2, atol=1e-4)


def test_schedules_match_jax():
    counts = np.arange(0, 40, dtype=np.int32)
    for jfn, tfn in [
            (jsched.warmup_linear_decay(0.01, 30, 5),
             tsched.warmup_linear_decay(0.01, 30, 5)),
            (jsched.warmup_hold_decay(0.01, 30, 5, 10),
             tsched.warmup_hold_decay(0.01, 30, 5, 10)),
            (jsched.constant(0.003), tsched.constant(0.003))]:
        want = np.array([float(jfn(jnp.asarray(c))) for c in counts])
        got = np.array([float(tfn(torch.tensor(c))) for c in counts])
        np.testing.assert_array_equal(got.astype(np.float32),
                                      want.astype(np.float32))
        out = tfn(torch.tensor(3, dtype=torch.int32))
        assert out.dtype == torch.float32 and out.ndim == 0
    s1, s2 = tsched.paper_stage_schedules()
    j1, _ = jsched.paper_stage_schedules()
    assert (s1.warmup_steps, s1.hold_steps) == (j1.warmup_steps,
                                                j1.hold_steps)
    np.testing.assert_allclose(tsched.schedule_auc(s1.schedule(), 100),
                               jsched.schedule_auc(j1.schedule(), 100),
                               rtol=1e-6)
    assert tsched.figure1_settings() == jsched.figure1_settings()
    assert tsched.sqrt_scaling_rule(1e-3, 512, 2048) == \
        jsched.sqrt_scaling_rule(1e-3, 512, 2048)
    assert s2.total_steps == 782
