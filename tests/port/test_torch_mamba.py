"""The port's Mamba-2 block (models/mamba2.py) against the JAX package's
on the same inputs, fp32: the chunked scan, the recurrent decode step
token by token, the state and conv tail carried across prefill chunks
and left padding within 1e-5; gradients within 1e-4 (sums over every
position and chunk of a weight's gradient, up to |g| ~ 30). Mirrors
tests/test_models.py:123,140."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as jmamba
from repro_torch.models import mamba2 as tmamba

F32 = dict(rtol=1e-5, atol=1e-5)
KW = dict(d_model=32, d_inner=64, headdim=16, dstate=8, chunk=4)


def _setup(seed=0, **over):
    kw = {**KW, **over}
    jcfg, tcfg = jmamba.MambaConfig(**kw), tmamba.MambaConfig(**kw)
    p = jax.tree.map(np.asarray,
                     jmamba.mamba_init(jax.random.PRNGKey(seed), jcfg))
    # non-trivial stabilisers, so that dt_bias, D and the norm count
    rng = np.random.default_rng(seed)
    h = jcfg.nheads
    p["dt_bias"] = rng.normal(size=(h,)).astype(np.float32)
    p["D"] = rng.normal(size=(h,)).astype(np.float32)
    p["conv_b"] = 0.1 * rng.normal(size=p["conv_b"].shape).astype(np.float32)
    p["norm"]["scale"] = 0.1 * rng.normal(size=(kw["d_inner"],)).astype(
        np.float32)
    return jcfg, tcfg, p, _tree_t(p)


def _tree_t(p):
    return {k: _tree_t(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in p.items()}


def _x(B, S, seed=1):
    return (0.5 * np.random.default_rng(seed).normal(
        size=(B, S, KW["d_model"]))).astype(np.float32)


def _jcache(B, cfg):
    return jmamba.init_mamba_cache(B, cfg)


def _tcache(B, cfg):
    c = tmamba.init_mamba_cache(B, cfg)
    c["index"] = torch.zeros((), dtype=torch.int32)
    return c


def test_init_shapes_match_jax():
    jcfg, tcfg, p, _ = _setup()
    with torch.device("meta"):
        tp = tmamba.mamba_init(None, tcfg)
    got = jax.tree.map(lambda a: tuple(a.shape), _tree_t(p))
    want = {k: ({kk: tuple(vv.shape) for kk, vv in v.items()}
                if isinstance(v, dict) else tuple(v.shape))
            for k, v in tp.items()}
    assert got == want
    np.testing.assert_array_equal(
        tmamba.mamba_init(torch.Generator().manual_seed(0), tcfg)[
            "A_log"].numpy(),
        np.asarray(jmamba.mamba_init(jax.random.PRNGKey(0), jcfg)["A_log"]))


@pytest.mark.parametrize("S", [4, 16])
def test_chunked_scan_matches_jax(S):
    jcfg, tcfg, p, tp = _setup()
    x = _x(2, S)
    want, _ = jmamba.mamba_apply(p, jcfg, x, compute_dtype=jnp.float32)
    got, _ = tmamba.mamba_apply(tp, tcfg, torch.from_numpy(x),
                                compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_recurrent_decode_matches_jax_token_by_token():
    """S == 1 steps against a cache: outputs, SSM state and conv tail
    equal the JAX step's after every token; and (state-space duality)
    the stepped outputs equal the chunked scan's."""
    jcfg, tcfg, p, tp = _setup()
    x = _x(2, 12)
    jc, tc = _jcache(2, jcfg), _tcache(2, tcfg)
    outs = []
    for i in range(12):
        jo, jc = jmamba.mamba_apply(p, jcfg, x[:, i:i + 1], cache=jc,
                                    compute_dtype=jnp.float32)
        to, tc = tmamba.mamba_apply(tp, tcfg, torch.from_numpy(x[:, i:i + 1]),
                                    cache=tc, compute_dtype=torch.float32)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **F32)
        for k in ("ssm", "conv"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       **F32)
        outs.append(to[:, 0])
    full, _ = tmamba.mamba_apply(tp, tcfg, torch.from_numpy(x),
                                 compute_dtype=torch.float32)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=1e-4, atol=1e-4)
    assert int(tc["index"]) == 12


def test_state_carried_across_prefill_chunks():
    """Two prefill chunks against one cache (state and conv tail carried)
    equal one whole prefill, and the JAX package's chunked run; the
    cache is written in place and stays fp32."""
    jcfg, tcfg, p, tp = _setup()
    x = _x(1, 16)
    jc, tc = _jcache(1, jcfg), _tcache(1, tcfg)
    ssm = tc["ssm"]
    jparts, tparts = [], []
    for lo, hi in ((0, 8), (8, 16)):
        jo, jc = jmamba.mamba_apply(p, jcfg, x[:, lo:hi], cache=jc,
                                    compute_dtype=jnp.float32)
        to, tc = tmamba.mamba_apply(tp, tcfg, torch.from_numpy(x[:, lo:hi]),
                                    cache=tc, compute_dtype=torch.float32)
        jparts.append(np.asarray(jo))
        tparts.append(to.numpy())
    np.testing.assert_allclose(np.concatenate(tparts, 1),
                               np.concatenate(jparts, 1), **F32)
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **F32)
        assert tc[k].dtype == torch.float32
    assert tc["ssm"] is ssm
    full, _ = tmamba.mamba_apply(tp, tcfg, torch.from_numpy(x),
                                 compute_dtype=torch.float32)
    np.testing.assert_allclose(np.concatenate(tparts, 1), full.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_left_pads_leave_no_trace():
    """A left-padded prefill (valid False at the pads) matches the JAX
    package's, and its real rows, final state and conv tail equal a
    pad-free run of the same tokens."""
    jcfg, tcfg, p, tp = _setup()
    x = _x(2, 16)
    valid = np.ones((2, 16), bool)
    valid[0, :4] = False
    x[0, :4] = 9.0                       # garbage under the pads
    jc, tc = _jcache(2, jcfg), _tcache(2, tcfg)
    want, jc = jmamba.mamba_apply(p, jcfg, x, cache=jc, valid=valid,
                                  compute_dtype=jnp.float32)
    got, tc = tmamba.mamba_apply(tp, tcfg, torch.from_numpy(x), cache=tc,
                                 valid=torch.from_numpy(valid),
                                 compute_dtype=torch.float32)
    np.testing.assert_allclose(got[:, 4:].numpy(), np.asarray(want)[:, 4:],
                               **F32)
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **F32)
    # the same 12 tokens alone, no padding (12 is a whole number of
    # chunks)
    solo, solo_c = tmamba.mamba_apply(tp, tcfg, torch.from_numpy(x[:1, 4:]),
                                      cache=_tcache(1, tcfg),
                                      compute_dtype=torch.float32)
    np.testing.assert_allclose(solo[0].numpy(), got[0, 4:].numpy(), **F32)
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(solo_c[k][0].numpy(), tc[k][0].numpy(),
                                   **F32)


def test_mamba_grads_match_jax():
    """Gradients of a chunked forward w.r.t. the input and every param
    within 1e-4 (the decay mask goes in before the exp, so no NaN)."""
    jcfg, tcfg, p, tp = _setup()
    x = _x(2, 8)

    def jloss(p, x):
        out, _ = jmamba.mamba_apply(p, jcfg, x, compute_dtype=jnp.float32)
        return jnp.sum(out * out)

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(p, x)
    leaves = []

    def req(t):
        return {k: req(v) if isinstance(v, dict)
                else leaves.append((k, v.requires_grad_())) or v
                for k, v in t.items()}

    tp = req(tp)
    tx = torch.from_numpy(x).requires_grad_()
    out, _ = tmamba.mamba_apply(tp, tcfg, tx, compute_dtype=torch.float32)
    torch.sum(out * out).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg_x),
                               rtol=1e-4, atol=1e-4)
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jg_p)[0])
    for path, g in flat_j.items():
        node = tp
        for k in path:
            node = node[k.key]
        assert torch.isfinite(node.grad).all()
        np.testing.assert_allclose(node.grad.numpy(), np.asarray(g),
                                   rtol=1e-4, atol=1e-4, err_msg=str(path))
