"""The port's LAMB, AdamW and SGD optimizers and the plain versions of
kernels K5-K6 against the JAX package, on the same numpy inputs:

  * plain K5-K6 (repro_torch/kernels/lamb.py) composed by
    ops.fused_lamb_step against repro/kernels/ref.py:lamb_step_ref (fed
    g * clip, since the oracle leaves the clip to its caller) and against
    the Pallas kernels behind repro.kernels.ops.fused_lamb_step
    (interpret mode), over the cases chip_smoke.py runs on the card: g/x
    fp32 and bf16, step 1 and 4, lam 0 with trust off, a zero-gradient
    leaf, a NaN in g, clip 1 and 0.3;
  * lamb (with and without phi_clip), fused_lamb, adamw, bn_adamw and sgd
    (plain, momentum, Nesterov) trajectories over 4 steps against the
    JAX transforms, and trajectories handed over mid-way from JAX to the
    port through bridge.opt_state_from_jax;
  * the base helpers identity, scale and tree_zeros_like.

Tolerance: 2e-5 (rtol and atol) with fp32 operands and 2e-2 with bf16
ones, as tests/test_kernels.py holds the Pallas kernels to their oracle.
The 4-step trajectories hold to 1e-5 relative (1e-6 absolute), fp32 on
both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import schedules as jsched
from repro.core.optim import adamw as jadamw
from repro.core.optim import apply_updates as japply
from repro.core.optim import bn_adamw as jbn_adamw
from repro.core.optim import identity as jidentity
from repro.core.optim import lamb as jlamb
from repro.core.optim import scale as jscale
from repro.core.optim import sgd as jsgd
from repro.core.optim.base import tree_zeros_like as jzeros_like
from repro.core.optim.fused import fused_lamb as jfused_lamb
from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.bridge import opt_state_from_jax
from repro_torch.core import schedules as tsched
from repro_torch.core.optim import adamw as tadamw
from repro_torch.core.optim import apply_updates as tapply
from repro_torch.core.optim import bn_adamw as tbn_adamw
from repro_torch.core.optim import fused_lamb as tfused_lamb
from repro_torch.core.optim import identity as tidentity
from repro_torch.core.optim import lamb as tlamb
from repro_torch.core.optim import scale as tscale
from repro_torch.core.optim import sgd as tsgd
from repro_torch.core.optim.base import tree_items
from repro_torch.core.optim.base import tree_zeros_like as tzeros_like
from repro_torch.kernels import lamb as kb
from repro_torch.kernels import lans as kl
from repro_torch.kernels import ops as tops

from .test_torch_lans import (_assert_trees, _grads, _jax_case, _np, _to_j,
                              _to_t, _tree)

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
KINDS = [("normal", 0.01, True), ("normal", 0.0, False),
         ("zero_grad", 0.01, True)]
KW = dict(beta1=0.9, beta2=0.999, eps=1e-6)


@pytest.mark.parametrize("clip", [1.0, 0.3])
@pytest.mark.parametrize("kind,lam,trust", KINDS)
@pytest.mark.parametrize("step", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 127, 32773])
def test_plain_lamb_step_matches_ref(n, dtype, step, kind, lam, trust, clip):
    """K5-K6 plain, composed by ops.fused_lamb_step, against the oracle
    on the clipped gradient."""
    case = kl.lans_case(n, dtype, kind=kind, seed=n + step)
    tol = F32 if dtype == torch.float32 else BF16
    got = tops.fused_lamb_step(*case, eta=0.02, step=step, clip=clip,
                               lam=lam, apply_trust=trust)
    g, m, v, x = _jax_case(case, dtype)
    want = ref.lamb_step_ref(g.astype(jnp.float32) * jnp.float32(clip), m,
                             v, x, eta=0.02, step=step, lam=lam,
                             apply_trust=trust)
    assert got.x.dtype == dtype and got.m.dtype == torch.float32
    for a, b in zip(got, want):
        assert np.isfinite(_np(a)).all()
        np.testing.assert_allclose(_np(a), _np(b), **tol)


@pytest.mark.parametrize("kind,lam,trust", KINDS + [("nan_grad", 0.01,
                                                      True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_lamb_step_matches_pallas(dtype, kind, lam, trust):
    """ops.fused_lamb_step against the Pallas pipeline (interpret mode),
    across a tile boundary of the TPU layout (32773 > 256 x 128), with a
    clip of 0.3. A NaN in g is not guarded, as in the kernels: m, v and
    x are NaN where g is, and the same elsewhere (equal_nan)."""
    case = kl.lans_case(32773, dtype, kind=kind, seed=7)
    got = tops.fused_lamb_step(*case, eta=0.02, step=4, clip=0.3, lam=lam,
                               apply_trust=trust)
    want = jops.fused_lamb_step(*_jax_case(case, dtype), eta=0.02, step=4,
                                clip=0.3, lam=lam, apply_trust=trust)
    for a, b in zip(got, want):
        np.testing.assert_allclose(
            _np(a), _np(b), equal_nan=True,
            **(F32 if dtype == torch.float32 else BF16))
    if kind == "nan_grad":
        nan = np.isnan(_np(got.x))
        assert nan.sum() == 1 and nan[32773 // 2]


def test_lamb_phase1_norms_layout_and_nan():
    """K5's norms are [u_sq, x_sq, 0 x 6]; with a NaN in g, u_sq is NaN
    and K6 selects trust 1 (NaN > 0 is false), so only the NaN element's
    x is NaN."""
    scal = tops.lamb_scalars(0.01, 2, 0.5, lam=0.01, apply_trust=True,
                             beta1=0.9, beta2=0.999, device="cpu")
    g, m, v, x = kl.lans_case(300)
    m1, v1, norms = kb.lamb_phase1(scal, g, m, v, x, **KW)
    assert torch.equal(norms[2:], torch.zeros(6))
    np.testing.assert_allclose(float(norms[1]), float((x * x).sum()),
                               rtol=1e-6)
    np.testing.assert_allclose(_np(m1), _np(0.9 * m + 0.1 * (g * 0.5)),
                               rtol=1e-6)
    u = ((m1 / scal[0]) / (torch.sqrt(v1 / scal[1]) + 1e-6) + 0.01 * x)
    np.testing.assert_allclose(float(norms[0]), float((u * u).sum()),
                               rtol=1e-5)
    x_new = kb.lamb_phase2(scal, norms, m1, v1, x, eps=1e-6)
    trust = torch.sqrt(norms[1]) / torch.sqrt(norms[0])
    np.testing.assert_allclose(_np(x_new), _np(x - 0.01 * trust * u),
                               rtol=1e-5, atol=1e-7)
    g, m, v, x = kl.lans_case(300, kind="nan_grad")
    m1, v1, norms = kb.lamb_phase1(scal, g, m, v, x, **KW)
    assert torch.isnan(norms[0]) and torch.isfinite(norms[1])
    x_new = kb.lamb_phase2(scal, norms, m1, v1, x, eps=1e-6)
    assert torch.isnan(x_new).sum() == 1 and torch.isnan(x_new[150])


def test_lamb_scalar_rows_are_the_per_tensor_scalars():
    """The step's rows carry the clip in slot 5 (a Python number or a 0-d
    tensor) and equal the scalars one tensor's step would build."""
    step, clip = torch.tensor(3, dtype=torch.int32), torch.tensor(0.25)
    rows = tops.lamb_scalar_rows(torch.tensor(0.5), step, clip,
                                 [False, True], beta1=0.9, beta2=0.999,
                                 lam=0.01, device="cpu")
    assert rows.shape == (2, 8) and bool((rows[:, 5] == 0.25).all())
    for row, decay in zip(rows.unbind(0), (False, True)):
        want = tops.lamb_scalars(0.5, 3, 0.25, beta1=0.9, beta2=0.999,
                                 lam=0.01 if decay else 0.0,
                                 apply_trust=decay, device="cpu")
        assert row.is_contiguous() and torch.equal(row, want)
    lans_row = tops.lans_scalars(0.5, 3, beta1=0.9, beta2=0.999, lam=0.01,
                                 apply_trust=True, device="cpu")
    assert torch.equal(rows[1, :5], lans_row[:5])
    with pytest.raises(TypeError, match="scalars"):
        tops.fused_lamb_step(*kl.lans_case(4), eta=0.1)


# --------------------------------------------------------------------------
# transforms over trees
# --------------------------------------------------------------------------

def _pair(kind):
    """(JAX transform, port transform) of one optimizer setting, with the
    warmup-hold-decay schedule where it takes one."""
    jsch = jsched.warmup_hold_decay(1e-2, 10, 2, 3)
    tsch = tsched.warmup_hold_decay(1e-2, 10, 2, 3)
    return {
        "lamb": (jlamb(jsch), tlamb(tsch)),
        "lamb_phi_clip": (jlamb(jsch, phi_clip=(0.1, 2.0)),
                          tlamb(tsch, phi_clip=(0.1, 2.0))),
        "lamb_no_clip": (jlamb(jsch, grad_clip_norm=None),
                         tlamb(tsch, grad_clip_norm=None)),
        "fused_lamb": (jfused_lamb(jsch), tfused_lamb(tsch)),
        "adamw": (jadamw(jsch), tadamw(tsch)),
        "bn_adamw": (jbn_adamw(jsch), tbn_adamw(tsch)),
        "sgd": (jsgd(1e-2), tsgd(1e-2)),
        "sgd_momentum": (jsgd(jsch, mu=0.9), tsgd(tsch, mu=0.9)),
        "sgd_nesterov": (jsgd(jsch, mu=0.9, nesterov=True),
                         tsgd(tsch, mu=0.9, nesterov=True)),
    }[kind]


def _steps(jtx, ttx, grads, jp, tp, js, ts):
    for g in grads:
        ju, js = jtx.update(_to_j(g), js, jp)
        jp = japply(jp, ju)
        tu, ts = ttx.update(_to_t(g), ts, tp)
        tp = tapply(tp, tu)
    return jp, tp, js, ts


def _grads4(seed):
    rng = np.random.default_rng(seed)
    p0 = _tree(rng)
    grads = [_grads(rng, p0, i) for i in range(4)]
    grads[2]["layers"]["bias"][:] = 0.0            # a zero-gradient block
    return p0, grads


KINDS_TX = ["lamb", "lamb_phi_clip", "lamb_no_clip", "fused_lamb", "adamw",
            "bn_adamw", "sgd", "sgd_momentum", "sgd_nesterov"]


@pytest.mark.parametrize("kind", KINDS_TX)
def test_trajectory_matches_jax(kind):
    """4 steps of the port's transform and the JAX one on the same params
    and gradients. The gradients' global norm exceeds 1, so LAMB's clip
    is active."""
    p0, grads = _grads4(0)
    jtx, ttx = _pair(kind)
    jp, tp = _to_j(p0), _to_t(p0)
    jp, tp, _, _ = _steps(jtx, ttx, grads, jp, tp, jtx.init(jp),
                          ttx.init(tp))
    _assert_trees(tp, jp, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["lamb", "fused_lamb", "adamw",
                                  "sgd_nesterov"])
def test_state_from_jax_continues_trajectory(kind):
    """2 steps in the JAX package, then the params and the optimizer state
    go to the port (bridge.opt_state_from_jax), and 2 more steps on each
    side agree, params and first moments."""
    p0, grads = _grads4(1)
    jtx, ttx = _pair(kind)
    jp = _to_j(p0)
    js = jtx.init(jp)
    for g in grads[:2]:
        ju, js = jtx.update(_to_j(g), js, jp)
        jp = japply(jp, ju)
    ts = opt_state_from_jax(jax.tree.map(np.asarray, js))
    assert type(ts).__name__ == type(js).__name__
    chained = type(ts) is tuple      # chain(...) states; fused_lamb's is one
    count = ts[-1].count if chained else ts.count
    assert int(count) == 2 and count.dtype == torch.int32
    tp = _to_t(jax.tree.map(np.asarray, jp))
    jp, tp, js, ts = _steps(jtx, ttx, grads[2:], jp, tp, js, ts)
    _assert_trees(tp, jp, rtol=1e-5, atol=1e-6)
    inner_j, inner_t = (js[0], ts[0]) if chained else (js, ts)
    first = "momentum" if kind == "sgd_nesterov" else "mu"
    _assert_trees(getattr(inner_t, first), getattr(inner_j, first),
                  rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="no port"):
        opt_state_from_jax(object())


def test_base_helpers_match_jax():
    rng = np.random.default_rng(3)
    p = _tree(rng)
    g = _grads(rng, p, 0)
    for jtx, ttx in ((jidentity(), tidentity()), (jscale(-0.5),
                                                  tscale(-0.5))):
        ju, _ = jtx.update(_to_j(g), jtx.init(_to_j(p)))
        tu, state = ttx.update(_to_t(g), ttx.init(_to_t(p)))
        assert state == ()
        _assert_trees(tu, ju, rtol=0, atol=0)
    tz = tzeros_like(_to_t(p), dtype=torch.bfloat16)
    jz = jzeros_like(_to_j(p), dtype=jnp.bfloat16)
    for (path, t), j in zip(tree_items(tz), jax.tree.leaves(jz)):
        assert t.dtype == torch.bfloat16 and not t.any(), path
        assert t.shape == j.shape, path
