"""The paged decode-attention kernels' plain versions against the JAX
oracles: K8's (paged_attention_fused_plain) against
repro/kernels/ref.py:paged_attention_fused_ref, K7's (the CPU route of
paged_attention) against ref.py:paged_attention_ref. The CUDA kernels
are held to these plain versions in test_torch_cuda_kernels.py.

Tolerance: outputs agree to 1e-5 (atol and rtol) — fp32 arithmetic on
both sides, differing only in summation order. Arenas must be
bit-identical: the write copies values, it never computes them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.kernels import paged_attention as pa

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _case(seed, *, S, wrap=False, null_write=False, B=3, h=4, n_kv=2,
          hd=16, bs=8, nb=4, n_blocks=14):
    """Pool-shaped inputs: slots own exclusive blocks, slot 1 has a short
    chain (the rest of its table is the null block), slot 2 is dead
    (all-null table, q_pos -1); positions are random with -1 rows, and
    the null block stays -1. Every valid row's destination is a real
    block, as the allocator guarantees — unless null_write, which puts
    slot 1's cursor at the end of its chain so that a valid row lands on
    a null table entry (neither written nor attended to)."""
    rng = np.random.default_rng(seed)
    ring = nb * bs
    pos = rng.integers(-1, 40, size=(n_blocks, bs)).astype(np.int32)
    pos[0] = -1
    tbl = np.zeros((B, nb), np.int32)
    tbl[0] = np.arange(1, 1 + nb)
    tbl[1, :2] = [5, 6]
    cur0 = ring - 2 if wrap else 17
    cur1 = 2 * bs - S // 2 if null_write else 9
    cursor = np.array([cur0, cur1, 0], np.int32)[:B]
    qpos = np.stack([40 + np.arange(S), 30 + np.arange(S),
                     np.full(S, -1)]).astype(np.int32)[:B]
    if S > 1:
        qpos[1, -1] = -1                        # a padding row of a block
    return dict(
        q=rng.normal(size=(B, S, h, hd)).astype(np.float32),
        k_new=rng.normal(size=(B, S, n_kv, hd)).astype(np.float32),
        v_new=rng.normal(size=(B, S, n_kv, hd)).astype(np.float32),
        k_arena=rng.normal(size=(n_blocks, bs, n_kv, hd)).astype(np.float32),
        v_arena=rng.normal(size=(n_blocks, bs, n_kv, hd)).astype(np.float32),
        pos_arena=pos, tables=tbl, q_pos=qpos, cursor=cursor)


FLOATS = ("q", "k_new", "v_new", "k_arena", "v_arena")
ORDER = ("q", "k_new", "v_new", "k_arena", "v_arena", "pos_arena",
         "tables", "q_pos", "cursor")


def _jax_args(case, jdt, squeeze):
    args = {k: jnp.asarray(v, jdt) if k in FLOATS else jnp.asarray(v)
            for k, v in case.items()}
    if squeeze:
        for k in ("q", "k_new", "v_new", "q_pos"):
            args[k] = args[k][:, 0]
    return [args[k] for k in ORDER]


def _torch_args(jax_args, device="cpu"):
    out = []
    for a in jax_args:
        t = torch.from_numpy(np.asarray(a, np.float32 if a.dtype ==
                                        jnp.bfloat16 else a.dtype).copy())
        if a.dtype == jnp.bfloat16:
            t = t.to(torch.bfloat16)
        out.append(t.to(device))
    return out


VARIANTS = [dict(), dict(window=8), dict(softcap=5.0),
            dict(window=8, softcap=5.0), dict(wrap=True, window=12),
            dict(null_write=True, window=8)]


@pytest.mark.parametrize("kw", VARIANTS, ids=lambda k: str(k) or "plain")
@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_plain_matches_jax_oracle(kw, S, dt):
    kw = dict(kw)
    case = _case(S * 10 + len(kw), S=S, wrap=kw.pop("wrap", False),
                 null_write=kw.pop("null_write", False))
    jargs = _jax_args(case, DTYPES[dt][0], squeeze=S == 1)
    want = ref.paged_attention_fused_ref(*jargs, scale=0.25, **kw)
    targs = _torch_args(jargs)
    out = pa.paged_attention_fused(*targs, scale=0.25, **kw)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)
    for got, w, name in zip(targs[3:6], want[1:], ("k", "v", "pos")):
        np.testing.assert_array_equal(
            got.float().numpy() if got.is_floating_point() else got.numpy(),
            np.asarray(w, np.float32 if name != "pos" else np.int32),
            err_msg=f"{name} arena not bit-identical")
    # the dead slot returns exactly 0, and nothing is NaN
    assert torch.isfinite(out).all()
    assert (out[-1] == 0).all()


def test_cpu_wrapper_counts_no_launch():
    case = _case(0, S=1)
    before = pa.paged_attention_fused.launches
    pa.paged_attention_fused(*_torch_args(_jax_args(case, jnp.float32,
                                                    True)), scale=0.25)
    assert pa.paged_attention_fused.launches == before


READ = ("q", "k_arena", "v_arena", "pos_arena", "tables", "q_pos")


@pytest.mark.parametrize("kw", [dict(), dict(window=8, softcap=5.0),
                                dict(wrap=True, window=12)],
                         ids=lambda k: str(k) or "plain")
@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_k7_plain_matches_jax_oracle(kw, S, dt):
    """K7's CPU route (q (B, h, hd) for S=1, (B, S, h, hd) otherwise)
    against the read-side oracle on the same arenas; the dead slot
    returns exactly 0 and nothing is written."""
    kw = dict(kw)
    case = _case(S * 7 + len(kw), S=S, wrap=kw.pop("wrap", False))
    jargs = dict(zip(ORDER, _jax_args(case, DTYPES[dt][0], S == 1)))
    want = ref.paged_attention_ref(*(jargs[k] for k in READ), scale=0.25,
                                   **kw)
    targs = dict(zip(ORDER, _torch_args([jargs[k] for k in ORDER])))
    before = [targs[k].clone() for k in READ]
    before_launches = pa.paged_attention.launches
    out = pa.paged_attention(*(targs[k] for k in READ), scale=0.25, **kw)
    assert pa.paged_attention.launches == before_launches
    assert out.dtype == torch.float32 and out.shape == targs["q"].shape
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert (out[-1] == 0).all() and torch.isfinite(out).all()
    for a, k in zip(before, READ):
        assert torch.equal(a, targs[k]), k
