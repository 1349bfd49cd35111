"""The CUDA kernels of the port against their plain versions, and the
kernel's layout limits. Imports no JAX, so that it also runs where the
card is:

  PYTHONPATH=src python -m pytest -q tests/port/test_torch_cuda_kernels.py

The tests that need the card skip on a machine without one.

Tolerance: kernel outputs agree with the plain version to 1e-5 (atol
and rtol), fp32 arithmetic on both sides in another summation order;
the arenas must be equal (torch.equal): the kernel copies the new rows,
it never computes them.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_attention as pa


@pytest.mark.parametrize("layout,ok", [
    (dict(block_size=16, head_dim=256, n_heads=8, n_kv=4, S=1), True),
    (dict(block_size=16, head_dim=256, n_heads=8, n_kv=4, S=4), True),
    (dict(block_size=4, head_dim=64, n_heads=4, n_kv=2, S=8), False),
    (dict(block_size=64, head_dim=256, n_heads=32, n_kv=1, S=16), False),
    (dict(block_size=16, head_dim=64, n_heads=6, n_kv=4, S=1), False),
    # granite-moe-3b-a800m's heads: 3 query heads per KV head, hd 64
    (dict(block_size=16, head_dim=64, n_heads=24, n_kv=8, S=1), True),
    (dict(block_size=16, head_dim=64, n_heads=24, n_kv=8, S=16), True),
])
def test_kernel_fit_raises_on_cuda_only(layout, ok):
    layout = dict(layout)
    args = (layout.pop("block_size"), layout.pop("head_dim"),
            layout.pop("n_heads"), layout.pop("n_kv"), torch.bfloat16)
    assert (pa.ensure_kernel_fit(*args, **layout) == []) == ok
    if ok:
        assert pa.ensure_kernel_fit(*args, **layout, device="cuda") == []
    else:
        with pytest.raises(ValueError, match="cannot take this layout"):
            pa.ensure_kernel_fit(*args, **layout, device="cuda")


def test_decode_case_plain_semantics():
    """The case generator's contract, on the CPU: dead slot returns 0,
    every valid row lands in a real block, the null block stays -1."""
    args = pa.decode_case(B=4, S=4, n_heads=4, n_kv=2, head_dim=16,
                          block_size=8, nb=3, device="cpu")
    pos_before = args[5].clone()
    out = pa.paged_attention_fused(*args, scale=0.25, window=12,
                                   softcap=5.0)
    assert (out[-1] == 0).all() and torch.isfinite(out).all()
    assert (args[5][0] == -1).all()
    written = (args[5] != pos_before).sum().item()
    assert written == int((args[7] >= 0).sum())


@pytest.mark.parametrize("S", [1, 4])
def test_decode_case_null_write_row_is_dropped(S):
    """With null_write a valid new row of slot 1 lands on a null table
    entry: the plain version writes every valid row but that one, and
    the null block stays -1."""
    args = pa.decode_case(B=4, S=S, n_heads=4, n_kv=2, head_dim=16,
                          block_size=8, nb=4, device="cpu", null_write=True)
    pos_before = args[5].clone()
    out = pa.paged_attention_fused(*args, scale=0.25)
    assert torch.isfinite(out).all() and (out[-1] == 0).all()
    assert (args[5][0] == -1).all()
    written = (args[5] != pos_before).sum().item()
    assert written == int((args[7] >= 0).sum()) - 1


@pytest.mark.parametrize("null_write", [False, True])
@pytest.mark.parametrize("window,softcap", [(None, None), (24, 50.0)])
@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain(S, dtype, window, softcap, null_write):
    """Needs the card: the kernel against its plain version at gemma2-2b's
    head shapes (h=8, n_kv=4, hd=256, block 16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = pa.decode_case(B=4, S=S, n_heads=8, n_kv=4, head_dim=256,
                          block_size=16, nb=6, dtype=dtype, q_dtype=dtype,
                          device="cuda", seed=S, null_write=null_write)
    plain = [a.clone() for a in args]
    before = pa.paged_attention_fused.launches
    out = pa.paged_attention_fused(*args, scale=0.0625, window=window,
                                   softcap=softcap)
    want = pa.paged_attention_fused_plain(*plain, scale=0.0625,
                                          window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert pa.paged_attention_fused.launches == before + 1
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    for got, w in zip(args[3:6], plain[3:6]):
        assert torch.equal(got, w)
    assert (out[-1] == 0).all()


def _next_round(args, fl, n_emit, seed):
    """After a verify round in which slot b emitted n_emit[b] of its
    fl[b] rows: the pool's rollback (positions of rows cursor + n_emit ..
    cursor + S - 1 lowered to -1 through the table, as
    PagedCachePool.rollback_rows does; cursors rewound), then the next
    round's operands: fresh q / new rows, fl' = fl - n_emit real rows
    for a slot whose budget ran into the round (slot 0), fl again for
    the others. Mutates the arenas in args (they hold the first round's
    writes) and returns (operands, fl')."""
    q, k_new, v_new, k_arena, v_arena, pos, tables, q_pos, cursor = args
    B, S = q_pos.shape
    bs = pos.shape[1]
    ring = tables.shape[1] * bs
    tbl = tables.cpu().numpy()
    cur = cursor.cpu().numpy().copy()
    nxt = fl.copy()
    for b in range(B - 1):
        for r in range(cur[b] + n_emit[b], cur[b] + S):
            blk = tbl[b, (r % ring) // bs]
            if blk:
                pos[blk, (r % ring) % bs] = min(int(pos[blk, (r % ring) % bs]),
                                                -1)
        cur[b] += n_emit[b]
        if b == 0:
            nxt[b] = fl[b] - n_emit[b]
    g = torch.Generator(device=q.device).manual_seed(seed)
    fresh = [torch.randn(t.shape, generator=g, device=t.device).to(t.dtype)
             for t in (q, k_new, v_new)]
    qp = torch.full_like(q_pos, -1)
    for b in range(B - 1):
        qp[b, :nxt[b]] = torch.arange(nxt[b]) + int(cur[b])
    return fresh + [k_arena, v_arena, pos, tables, qp,
                    torch.as_tensor(cur, device=cursor.device)], nxt


@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("S", range(2, 17))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_k8_verify_rounds_match_plain(dtype, S, window):
    """Needs the card: K8 as the speculative verify step runs it, at S =
    2..block_size query rows (gemma2-2b's heads, block 16): row-margined
    tables one block wider than the rows, trailing rows at position -1
    (a budget-cut round), a dead slot; then, after a rollback (stale rows
    lowered to -1 by min, cursors rewound), a second round on the arenas
    the first wrote. Outputs within 1e-5 of the plain version, arenas
    torch.equal after each round. Every S fits at these heads: from
    S = 12 (fp32 arenas) or 14 (bf16) the split CTA folds with two key
    groups of warps (kernels/paged_attention.key_groups)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kw = dict(scale=0.0625, window=window, softcap=50.0)
    args, fl = pa.verify_case(S=S, n_heads=8, n_kv=4, head_dim=256,
                              block_size=16, nb=7, dtype=dtype,
                              q_dtype=dtype, device="cuda", seed=S)
    assert pa.kernel_fit_problems(16, 256, 8, 4, dtype, S=S) == []
    plain = [a.clone() for a in args]
    n_emit = np.array([1, 1, S, 0])
    for rnd in range(2):
        before = pa.paged_attention_fused.launches
        out = pa.paged_attention_fused(*args, **kw)
        want = pa.paged_attention_fused_plain(*plain, **kw)
        torch.cuda.synchronize()
        assert pa.paged_attention_fused.launches == before + 1
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5,
                                   msg=lambda m: f"round {rnd}: {m}")
        for got, w in zip(args[3:6], plain[3:6]):
            assert torch.equal(got, w), f"round {rnd}"
        assert (out[-1] == 0).all()
        if rnd == 0:
            args, nxt = _next_round(args, fl, n_emit, seed=S)
            plain, _ = _next_round(plain, fl, n_emit, seed=S)
            fl = nxt


def test_verify_case_and_rollback_on_cpu():
    """The verify case's contract, on the CPU (plain version): every real
    row lands in a backed block and the padding rows write nothing; the
    rollback leaves no position at or past each live slot's new cursor
    and the null block at -1."""
    S = 5
    args, fl = pa.verify_case(S=S, n_heads=4, n_kv=2, head_dim=16,
                              block_size=8, nb=5, device="cpu")
    tables = args[6]
    pos_before = args[5].clone()
    out = pa.paged_attention_fused(*args, scale=0.25, window=12,
                                   softcap=5.0)
    assert torch.isfinite(out).all() and (out[-1] == 0).all()
    assert int((args[5] != pos_before).sum()) == int(fl.sum())
    assert fl.tolist() == [2, S - 1, S, 0]
    args, nxt = _next_round(args, fl, np.array([1, 1, S, 0]), seed=0)
    assert nxt.tolist() == [1, S - 1, S, 0]
    pos, cur = args[5], args[8]
    for b in range(3):
        for blk in tables[b][tables[b] != 0].tolist():
            assert (pos[blk] < int(cur[b])).all()
    assert (pos[0] == -1).all()


# --------------------------------------------------------------------------
# K1-K4, the fused LANS step (kernels/lans.py, csrc/lans.cu)
#
# Tolerance: 2e-5 (rtol and atol) for every fp32 output (K1's sum, K2's
# m, v and norms, the masters), whatever g and x are, since bf16 inputs
# convert to fp32 exactly: fp32 arithmetic on both sides, sums in another
# order, and rsqrt / FMA rounding that differ by an ulp. 2e-2 for K3's x
# when x is bf16, as the JAX kernel sweep (tests/test_kernels.py) holds
# the TPU kernels to their oracle. Exact where the kernel copies
# or casts: K4's master equals K3's output and its lp copy equals the
# cast of that master (torch.equal), and K1 repeats bit for bit.
# --------------------------------------------------------------------------

from repro_torch.kernels import lans as kl  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402


def _lans_tol(dtype):
    t = 2e-5 if dtype == torch.float32 else 2e-2
    return dict(rtol=t, atol=t)


def test_lans_wrappers_reject_unsupported_dtypes_on_cuda_only():
    """On the CPU a wrapper runs its plain version for any float dtype;
    on CUDA it checks dtypes (fp16 g is not a kernel operand)."""
    g, m, v, x = kl.lans_case(5, torch.float32)
    assert torch.isfinite(kl.sq_norm(g.half())).all()
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with pytest.raises(TypeError):
        kl.sq_norm(g.half().cuda())
    with pytest.raises(TypeError):
        scal = kops.lans_scalars(0.01, 1, beta1=0.9, beta2=0.999, lam=0.0,
                                 apply_trust=True, device="cuda")
        norms = torch.zeros(8, device="cuda")
        kl.lans_phase2_cast(scal, norms, *(t.cuda() for t in (g, m, v)),
                            x.bfloat16().cuda(), lp_dtype=torch.bfloat16,
                            beta1=0.9, eps=1e-6)


@pytest.mark.parametrize("kind,lam,trust", [("normal", 0.01, True),
                                            ("normal", 0.0, False),
                                            ("zero_grad", 0.01, True),
                                            ("nan_grad", 0.01, True)])
@pytest.mark.parametrize("step", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 127, 32773, 1048579])
def test_cuda_lans_kernels_match_plain(n, dtype, step, kind, lam, trust):
    """Needs the card: K1-K4 each against its plain version on the same
    inputs, phase by phase, and the composed step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tol, f32 = _lans_tol(dtype), _lans_tol(torch.float32)
    kw = dict(beta1=0.9, eps=1e-6)
    g, m, v, x = kl.lans_case(n, dtype, kind=kind, seed=n + step,
                              device="cuda")
    before = [k.launches for k in kl.KERNELS]
    g_sq = kl.sq_norm(g)
    torch.testing.assert_close(g_sq, kl.sq_norm_plain(g), **f32,
                               equal_nan=True)
    assert torch.equal(kl.sq_norm(g), g_sq) or kind == "nan_grad"
    scal = kops.lans_scalars(0.02, step, beta1=0.9, beta2=0.999, lam=lam,
                             apply_trust=trust, device="cuda")
    scal[5] = kl.sq_norm_plain(g)
    got1 = kl.lans_phase1(scal, g, m, v, x, beta2=0.999, **kw)
    want1 = kl.lans_phase1_plain(scal, g, m, v, x, beta2=0.999, **kw)
    for a, b in zip(got1, want1):   # fp32 outputs whatever g and x are
        torch.testing.assert_close(a, b, **f32)
    m1, v1, norms = want1
    x3 = kl.lans_phase2(scal, norms, g, m1, v1, x, **kw)
    torch.testing.assert_close(
        x3.float(), kl.lans_phase2_plain(scal, norms, g, m1, v1, x,
                                         **kw).float(), **tol)
    if dtype == torch.float32:
        for lp in (torch.bfloat16, torch.float16, torch.float32):
            xm, xlp = kl.lans_phase2_cast(scal, norms, g, m1, v1, x,
                                          lp_dtype=lp, **kw)
            wm, _ = kl.lans_phase2_cast_plain(scal, norms, g, m1, v1, x,
                                              lp_dtype=lp, **kw)
            torch.testing.assert_close(xm, wm, **f32)
            assert torch.equal(xm, x3)
            assert torch.equal(xlp, xm.to(lp))
    torch.cuda.synchronize()
    launched = [k.launches - b for k, b in zip(kl.KERNELS, before)]
    assert launched == [2, 1, 1, 3 if dtype == torch.float32 else 0]
    step_out = kops.fused_lans_step(g, m, v, x, eta=0.02, step=step,
                                    lam=lam, apply_trust=trust)
    cpu = [t.cpu() for t in (g, m, v, x)]
    want = kops.fused_lans_step(*cpu, eta=0.02, step=step, lam=lam,
                                apply_trust=trust)
    for a, b, t in zip(step_out, want, (tol, f32, f32)):   # x, m, v
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a.cpu().float(), b.float(), **t)


def test_cuda_sq_norm_is_bitwise_repeatable():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g, _, _, _ = kl.lans_case(100_663_296 // 8, torch.float32, seed=1,
                              device="cuda")
    a, b = kl.sq_norm(g).clone(), kl.sq_norm(g).clone()
    assert torch.equal(a, b)


# --------------------------------------------------------------------------
# K5-K6, the fused LAMB step (kernels/lamb.py, csrc/lamb.cu)
#
# Tolerance: 2e-5 (rtol and atol) for every fp32 output (K5's m, v and
# norms, K6's fp32 x), whatever g and x are, as for K1/K2 above; 2e-2 for
# K6's x when x is bf16 (tests/test_kernels.py's tolerance). K5's norms
# repeat bit for bit. A NaN in g is not guarded (as in the reference), so
# outputs are compared with equal_nan.
# --------------------------------------------------------------------------

from repro_torch.kernels import lamb as kb  # noqa: E402


def test_lamb_wrappers_reject_unsupported_operands_on_cuda_only():
    """On the CPU a wrapper runs its plain version for any float dtype;
    on CUDA it raises on what the kernel does not take (fp16 g, a
    non-contiguous m, a scalars tensor of the wrong size)."""
    g, m, v, x = kl.lans_case(6, torch.float32)
    scal = kops.lamb_scalars(0.01, 1, 0.5, beta1=0.9, beta2=0.999, lam=0.0,
                             apply_trust=True, device="cpu")
    before = [k.launches for k in kb.KERNELS]
    out = kb.lamb_phase1(scal, g.half(), m, v, x, beta1=0.9, beta2=0.999,
                         eps=1e-6)
    assert all(torch.isfinite(t).all() for t in out)
    assert [k.launches for k in kb.KERNELS] == before
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g, m, v, x, scal = (t.cuda() for t in (g, m, v, x, scal))
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-6)
    with pytest.raises(TypeError):
        kb.lamb_phase1(scal, g.half(), m, v, x, **kw)
    with pytest.raises(ValueError):
        kb.lamb_phase1(scal, g, torch.zeros(12, device="cuda")[::2], v, x,
                       **kw)
    with pytest.raises(ValueError):
        kb.lamb_phase2(scal[:4], torch.zeros(8, device="cuda"), m, v, x,
                       eps=1e-6)


@pytest.mark.parametrize("clip", [1.0, 0.3])
@pytest.mark.parametrize("kind,lam,trust", [("normal", 0.01, True),
                                            ("normal", 0.0, False),
                                            ("zero_grad", 0.01, True),
                                            ("nan_grad", 0.01, True)])
@pytest.mark.parametrize("step", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 127, 32773, 1048579])
def test_cuda_lamb_kernels_match_plain(n, dtype, step, kind, lam, trust,
                                       clip):
    """Needs the card: K5 and K6 each against its plain version on the
    same inputs, K5's norms bitwise repeatable, and the composed step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tol, f32 = _lans_tol(dtype), _lans_tol(torch.float32)
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-6)
    g, m, v, x = kl.lans_case(n, dtype, kind=kind, seed=n + step,
                              device="cuda")
    scal = kops.lamb_scalars(0.02, step, clip, beta1=0.9, beta2=0.999,
                             lam=lam, apply_trust=trust, device="cuda")
    before = [k.launches for k in kb.KERNELS]
    got1 = kb.lamb_phase1(scal, g, m, v, x, **kw)
    want1 = kb.lamb_phase1_plain(scal, g, m, v, x, **kw)
    for a, b in zip(got1, want1):   # fp32 outputs whatever g and x are
        torch.testing.assert_close(a, b, **f32, equal_nan=True)
    assert torch.equal(kb.lamb_phase1(scal, g, m, v, x, **kw)[2], got1[2]) \
        or kind == "nan_grad"
    m1, v1, norms = want1
    x6 = kb.lamb_phase2(scal, norms, m1, v1, x, eps=1e-6)
    torch.testing.assert_close(
        x6.float(), kb.lamb_phase2_plain(scal, norms, m1, v1, x,
                                         eps=1e-6).float(), **tol,
        equal_nan=True)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kb.KERNELS, before)] == [2, 1]
    out = kops.fused_lamb_step(g, m, v, x, eta=0.02, step=step, clip=clip,
                               lam=lam, apply_trust=trust)
    cpu = [t.cpu() for t in (g, m, v, x)]
    want = kops.fused_lamb_step(*cpu, eta=0.02, step=step, clip=clip,
                                lam=lam, apply_trust=trust)
    for a, b, t in zip(out, want, (tol, f32, f32)):   # x, m, v
        assert torch.isfinite(a).all() or kind == "nan_grad"
        torch.testing.assert_close(a.cpu().float(), b.float(), **t,
                                   equal_nan=True)


# --------------------------------------------------------------------------
# K7, the read side of the paged-attention kernel
#
# Tolerance: 1e-5 (atol and rtol) against paged_attention_plain, fp32
# arithmetic on both sides in another summation order, as for K8; on
# K8's post-write arenas K7 equals K8's output to the same tolerance.
# --------------------------------------------------------------------------

def _read_args(args):
    """K7's operands (q, arenas, pos, tables, q_pos) of a decode case."""
    q, _, _, k_arena, v_arena, pos, tables, q_pos, _ = args
    return q, k_arena, v_arena, pos, tables, q_pos


def test_k7_wrapper_on_cpu_counts_no_launch_and_is_plain():
    args = pa.decode_case(B=4, S=3, n_heads=4, n_kv=2, head_dim=16,
                          block_size=8, nb=3, dtype=torch.float32,
                          device="cpu")
    before = pa.paged_attention.launches
    read = _read_args(args)
    kw = dict(scale=0.25, window=12, softcap=5.0)
    out = pa.paged_attention(*read, **kw)
    assert pa.paged_attention.launches == before
    assert torch.equal(out, pa.paged_attention_plain(*read, **kw))
    assert (out[-1] == 0).all()
    q, k, v, pos, tables, q_pos = read
    one = pa.paged_attention(q[:, 0], k, v, pos, tables, q_pos[:, 0], **kw)
    assert one.shape == q[:, 0].shape
    assert torch.equal(one, pa.paged_attention_plain(
        q[:, :1], k, v, pos, tables, q_pos[:, :1], **kw)[:, 0])


def _empty_batch(device):
    """A decode case cut to B = 0 slots (arenas kept)."""
    q, k_new, v_new, k, v, pos, tables, q_pos, cursor = pa.decode_case(
        B=4, S=2, n_heads=8, n_kv=4, head_dim=256, block_size=16, nb=6,
        dtype=torch.float32, device=device)
    return (q[:0], k_new[:0], v_new[:0], k, v, pos, tables[:0], q_pos[:0],
            cursor[:0])


def _counts():
    return pa.paged_attention.launches, pa.paged_attention_fused.launches


def test_empty_batch_launch_counts_nothing():
    """The shared launcher returns before the library for B = 0 and adds
    to a wrapper's count only after a launch, so an empty batch counts
    nothing (CPU operands: the path up to the launch is the card's)."""
    args = _empty_batch("cpu")
    kw = dict(scale=0.0625, causal=True, window=None, softcap=None)
    before = _counts()
    out8 = pa._launch(pa.paged_attention_fused, *args, **kw)
    out7 = pa._launch(pa.paged_attention, args[0], None, None,
                      *_read_args(args)[1:], None, **kw)
    assert _counts() == before
    assert out8.shape == out7.shape == (0, 2, 8, 256)


def test_cuda_empty_batch_counts_no_launch():
    """Needs the card: K7 and K8 on B = 0 slots launch nothing, and their
    counts stay as they were."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = _empty_batch("cuda")
    kw = dict(scale=0.0625)
    before = _counts()
    out8 = pa.paged_attention_fused(*args, **kw)
    out7 = pa.paged_attention(*_read_args(args), **kw)
    torch.cuda.synchronize()
    assert _counts() == before
    assert out8.shape == out7.shape == (0, 2, 8, 256)


def test_k7_fit_takes_more_query_rows_than_a_block():
    """K8 folds its S new rows in the block buffer, so S <= block_size;
    K7 folds none and takes S > block_size."""
    layout = (4, 64, 4, 2, torch.bfloat16)
    assert pa.kernel_fit_problems(*layout, S=8)
    assert pa.kernel_fit_problems(*layout, S=8, new_rows=False) == []
    assert pa.ensure_kernel_fit(*layout, S=8, new_rows=False,
                                device="cuda") == []


@pytest.mark.parametrize("window,softcap", [(None, None), (24, 50.0)])
@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_k7_matches_plain_and_k8(S, dtype, window, softcap):
    """Needs the card: K7 against its plain version at gemma2-2b's head
    shapes (h=8, n_kv=4, hd=256, block 16), a dead slot returning exactly
    0; then K8 writes the new rows and K7 on its post-write arenas, with
    the same q, equals K8's output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = pa.decode_case(B=4, S=S, n_heads=8, n_kv=4, head_dim=256,
                          block_size=16, nb=6, dtype=dtype, q_dtype=dtype,
                          device="cuda", seed=10 + S)
    kw = dict(scale=0.0625, window=window, softcap=softcap)
    read = _read_args(args)
    before = pa.paged_attention.launches
    out = pa.paged_attention(*read, **kw)
    want = pa.paged_attention_plain(*read, **kw)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    assert (out[-1] == 0).all()
    k8 = pa.paged_attention_fused(*args, **kw)
    k7 = pa.paged_attention(*read, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(k7, k8, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# The split-KV design of K7/K8 (csrc/paged_attention.cu): a long ring cut
# into several splits, splits that hold null blocks only, windows that
# exclude whole splits, and the fixed-order combine.
#
# Tolerance as above: 1e-5 against the plain versions, arenas torch.equal;
# two launches on the same inputs are equal bit for bit.
# --------------------------------------------------------------------------

def _long_case(dtype, S, seed, null_write=False):
    """A decode case on a 64-block ring at gemma2-2b's head shapes, with
    its split plan on this card."""
    args = pa.decode_case(B=4, S=S, n_heads=8, n_kv=4, head_dim=256,
                          block_size=16, nb=64, dtype=dtype,
                          q_dtype=torch.float32, device="cuda", seed=seed,
                          null_write=null_write)
    plan = pa.split_plan(64, 4, 4, pa._sm_count(args[0].device.index))
    return args, plan


@pytest.mark.parametrize("null_write", [False, True])
@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_split_kv_long_ring(dtype, S, window, null_write):
    """Needs the card: K7 (before the write) and K8 against their plain
    versions on a 64-block ring cut into several splits (split k: the
    entries k, k + n_split, ...). Slot 1 backs half its table, so some of
    its splits hold null blocks only; with window 40 whole splits of
    slot 0 lie outside the window. Arenas equal, the dead slot exactly 0,
    and K7 on K8's post-write arenas equal to K8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args, (n_split, _, _) = _long_case(dtype, S, 20 + S, null_write)
    tables, pos, q_pos = (a.cpu() for a in (args[6], args[5], args[7]))
    ranges = [range(k, 64, n_split) for k in range(n_split)]
    assert n_split > 1
    assert any(not tables[1, list(r)].any() for r in ranges)
    if window:
        def outside(r):
            kp = pos[tables[0, list(r)]]
            return bool(((kp < 0) | (q_pos[0, 0] - kp >= window)).all())
        assert any(outside(r) for r in ranges)
    kw = dict(scale=0.0625, window=window, softcap=50.0)
    read = _read_args(args)
    out7 = pa.paged_attention(*read, **kw)
    want7 = pa.paged_attention_plain(*read, **kw)
    plain = [a.clone() for a in args]
    out = pa.paged_attention_fused(*args, **kw)
    want = pa.paged_attention_fused_plain(*plain, **kw)
    after7 = pa.paged_attention(*_read_args(args), **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out7, want7, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(after7, out, rtol=1e-5, atol=1e-5)
    for got, w in zip(args[3:6], plain[3:6]):
        assert torch.equal(got, w)
    assert (out[-1] == 0).all() and (out7[-1] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_split_kv_repeats_bit_for_bit(dtype):
    """Needs the card: two launches of K8 on copies of the same inputs
    give equal outputs and arenas, and two of K7 equal outputs: the
    combine adds the splits in a fixed order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args, _ = _long_case(dtype, 4, 7)
    kw = dict(scale=0.0625, window=100, softcap=50.0)
    read = _read_args(args)
    k7 = [pa.paged_attention(*read, **kw) for _ in range(2)]
    copies = [[a.clone() for a in args] for _ in range(2)]
    k8 = [pa.paged_attention_fused(*c, **kw) for c in copies]
    torch.cuda.synchronize()
    assert torch.equal(k7[0], k7[1])
    assert torch.equal(k8[0], k8[1])
    for a, b in zip(copies[0][3:6], copies[1][3:6]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("attn_kernel", ["paged", "xla"])
def test_cuda_chunked_engine_matches_unchunked(attn_kernel):
    """Needs the card: reduced gemma2-2b (2 layers, block 8) served on
    CUDA with chunked-prefill admission (budget 6) gives the whole-prompt
    engine's greedy fp32 tokens; with the kernel path K8 launches
    decode steps x layers times in each run (chunk forwards, on the
    task's dense cache, launch none), with the gather path none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import reduced_arch
    from repro_torch.serving import ContinuousEngine, Request
    arch = reduced_arch("gemma2-2b")
    params = arch.init(torch.Generator(device="cuda").manual_seed(0))
    spec = [(7, 4), (23, 6), (5, 1), (17, 3), (11, 4), (21, 9)]
    runs = []
    for chunk_budget in (None, 6):
        reqs = [Request(prompt=np.random.default_rng([1, i]).integers(
                            5, arch.cfg.vocab, size=n).astype(np.int32),
                        max_new_tokens=m) for i, (n, m) in enumerate(spec)]
        eng = ContinuousEngine(arch, params, max_batch=3, max_len=48,
                               policy="fp32", block_size=8, prefill_bucket=8,
                               attn_kernel=attn_kernel,
                               chunk_budget=chunk_budget)
        pa.paged_attention_fused.launches = 0
        eng.run_batch(reqs)
        rep = eng.report(1.0)
        want = rep["decode_steps"] * arch.cfg.n_layers
        assert pa.paged_attention_fused.launches == (
            want if attn_kernel == "paged" else 0)
        assert rep["nonfinite_logit_steps"] == 0
        runs.append([r.generated.tolist() for r in reqs])
    assert rep["chunk_steps"] > 0
    assert runs[0] == runs[1]


# --------------------------------------------------------------------------
# granite-moe-3b-a800m's heads (h 24, n_kv 8: R = 3 S query rows per KV
# head, odd at S = 1, so the last two-row fold tile is half empty; hd 64,
# a quarter of a warp's 256-element span, so 8 of 32 lanes carry a dot
# product) with every query dtype the serving policies give: fp32, bf16
# and fp16 (fp16 serving). The tolerance stays 1e-5 for every q dtype:
# the kernel and the plain version both widen q exactly to fp32.
# --------------------------------------------------------------------------

GRANITE = dict(n_heads=24, n_kv=8, head_dim=64, block_size=16)
Q_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def granite_case(S, q_dtype, kv_dtype, device, seed, null_write=False):
    """K8's operands at granite's heads: decode_case at S = 1 (a dead
    slot, position -1 rows, optionally a new row on a null table entry),
    verify_case at S > 1 (row-margined tables, padding rows at -1)."""
    kw = dict(**GRANITE, dtype=kv_dtype, q_dtype=q_dtype, device=device,
              seed=seed)
    if S == 1:
        return pa.decode_case(B=4, S=1, nb=6, null_write=null_write, **kw)
    return pa.verify_case(S=S, nb=7, **kw)[0]


@pytest.mark.parametrize("q_dtype", Q_DTYPES)
def test_plain_versions_take_every_q_dtype_on_cpu(q_dtype):
    """On the CPU the wrappers run the plain versions for fp16 queries
    too, at granite's heads, and count no launch."""
    args = granite_case(1, q_dtype, torch.bfloat16, "cpu", 0)
    plain = [a.clone() for a in args]
    counts = (pa.paged_attention_fused.launches, pa.paged_attention.launches)
    out = pa.paged_attention_fused(*args, scale=0.125)
    want = pa.paged_attention_fused_plain(*plain, scale=0.125)
    k7 = pa.paged_attention(*_read_args(args), scale=0.125)
    assert torch.equal(out, want) and torch.equal(k7, out)
    assert out.dtype == torch.float32 and (out[-1] == 0).all()
    assert counts == (pa.paged_attention_fused.launches,
                      pa.paged_attention.launches)
    assert set(pa.Q_CODES) == set(Q_DTYPES)


@pytest.mark.parametrize("S,null_write", [(1, False), (1, True), (4, False)])
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("q_dtype", Q_DTYPES)
def test_cuda_kernels_at_granite_heads(q_dtype, kv_dtype, S, null_write):
    """Needs the card: K8 and K7 (on the arenas before the write) against
    their plain versions within 1e-5 at granite's heads, every q dtype,
    bf16 and fp32 arenas, S = 1 (decode) and 4 (a verify block); arenas
    torch.equal, the dead slot exactly 0, K7 on K8's post-write arenas
    equal to K8, and a second launch of each equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = granite_case(S, q_dtype, kv_dtype, "cuda", seed=S,
                        null_write=null_write)
    kw = dict(scale=0.125)
    read = _read_args(args)
    fresh = [a.clone() for a in args]
    out7, again7 = (pa.paged_attention(*read, **kw) for _ in range(2))
    want7 = pa.paged_attention_plain(*read, **kw)
    plain = [a.clone() for a in args]
    out = pa.paged_attention_fused(*args, **kw)
    want = pa.paged_attention_fused_plain(*plain, **kw)
    again = pa.paged_attention_fused(*fresh, **kw)
    after7 = pa.paged_attention(*_read_args(args), **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out7, want7, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(after7, out, rtol=1e-5, atol=1e-5)
    assert torch.equal(out7, again7) and torch.equal(out, again)
    for got, w, rep in zip(args[3:6], plain[3:6], fresh[3:6]):
        assert torch.equal(got, w) and torch.equal(rep, w)
    assert (out[-1] == 0).all() and (out7[-1] == 0).all()


# --------------------------------------------------------------------------
# the encoder-decoder and BERT serving families on the card (no kernel of
# their own: the paths around K1-K8 that the engine drives)
# --------------------------------------------------------------------------

def test_cuda_encdec_run_one_matches_pooled():
    """Needs the card: reduced whisper-large-v3 served on CUDA over two
    distinct inputs (shared cross blocks): greedy fp32 tokens of the
    pooled engine equal run_one's for each request, and the drained
    arena holds no live block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import reduced_arch
    from repro_torch.serving import (ContinuousEngine,
                                     synthetic_encdec_requests)
    arch = reduced_arch("whisper-large-v3")
    params = arch.init(torch.Generator(device="cuda").manual_seed(0))
    eng = ContinuousEngine(arch, params, max_batch=3, max_len=32,
                           prefill_bucket=8, block_size=8, policy="fp32")

    def requests():
        return synthetic_encdec_requests(
            6, arch.cfg.vocab, n_frames=arch.cfg.n_frames,
            d_model=arch.cfg.d_model, prompt_len=8, new_tokens=10,
            n_inputs=2, seed=1)
    pooled = eng.run_batch(requests())
    assert eng.report(1.0)["shared_block_hits"] > 0
    for p, s in zip(pooled, requests()):
        assert eng.run_one(s).generated.tolist() == p.generated.tolist()
    assert eng.pool.map.alloc.n_live == 0
    eng.pool.check_invariants()


@pytest.mark.parametrize("task", ["score", "embed"])
def test_cuda_scoring_run_one_matches_batched(task):
    """Needs the card: reduced bert-large scored on CUDA (fp32 policy):
    each request's run_one embedding within 1e-5 of the batched one, and
    the masked-LM ids equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import reduced_arch
    from repro_torch.serving import (ContinuousEngine,
                                     synthetic_scoring_requests)
    arch = reduced_arch("bert-large")
    params = arch.init(torch.Generator(device="cuda").manual_seed(0))
    eng = ContinuousEngine(arch, params, max_batch=4, max_len=32,
                           policy="fp32", task=task)

    def requests():
        return synthetic_scoring_requests(7, arch.cfg.vocab, prompt_len=32,
                                          seed=2)
    batched = eng.run_batch(requests())
    for b, s in zip(batched, requests()):
        eng.run_one(s)
        np.testing.assert_allclose(s.embedding, b.embedding, rtol=1e-5,
                                   atol=1e-5)
        assert s.generated.tolist() == b.generated.tolist()


# --------------------------------------------------------------------------
# leaves cut into shards (a leaf cut over the ranks of a mesh): each kernel
# runs on a shard, K1's g_sq and K2's / K5's norms are partial sums that
# the ranks add up, and the concatenated result is the whole leaf's. Runs
# on the CPU with the plain versions and, where the card is, with the
# kernels.
# --------------------------------------------------------------------------

from repro_torch.kernels import lamb as KB  # noqa: E402
from repro_torch.kernels import lans as KL  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


def _sharded_steps(g, m, v, x, n_shards, kind):
    """The fused step of `kind` ("lans", "mixed": K4 with a bf16 copy,
    "lamb") on n_shards shards of a flat leaf (torch.tensor_split: uneven
    when the length does not divide), the partial sums added between the
    phases. Returns the concatenated outputs."""
    cuts = [torch.tensor_split(t, n_shards) for t in (g, m, v, x)]
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-6)
    g_sq = sum(KL.sq_norm(s) for s in cuts[0])
    if kind == "lamb":
        from repro_torch.core.optim.lamb import clip_factor
        row = lambda: ops.lamb_scalars(0.02, 4, clip_factor(g_sq, 1.0),
                                       lam=0.01, apply_trust=True,
                                       beta1=0.9, beta2=0.999,
                                       device=g.device)
    else:
        def row():
            r = ops.lans_scalars(0.02, 4, beta1=0.9, beta2=0.999, lam=0.01,
                                 apply_trust=True, device=g.device)
            r[5] = g_sq
            return r
    rows = [row() for _ in range(n_shards)]
    phase1 = KB.lamb_phase1 if kind == "lamb" else KL.lans_phase1
    p1 = [phase1(r, gs, ms, vs, xs, **kw)
          for r, gs, ms, vs, xs in zip(rows, *cuts)]
    norms = sum(p[2] for p in p1)
    outs = []
    for r, gs, xs, (m1, v1, _) in zip(rows, cuts[0], cuts[3], p1):
        if kind == "lamb":
            outs.append((KB.lamb_phase2(r, norms, m1, v1, xs, eps=1e-6),
                         m1, v1))
        elif kind == "mixed":
            outs.append((*KL.lans_phase2_cast(
                r, norms, gs, m1, v1, xs, lp_dtype=torch.bfloat16,
                beta1=0.9, eps=1e-6)[::-1], m1, v1))
        else:
            outs.append((KL.lans_phase2(r, norms, gs, m1, v1, xs, beta1=0.9,
                                        eps=1e-6), m1, v1))
    return [torch.cat(parts) for parts in zip(*outs)]


@pytest.mark.parametrize("n", [1_048_576, 1_048_579])
@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("kind", ["lans", "mixed", "lamb"])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_sharded_leaf_matches_whole_leaf(device, kind, n_shards, n):
    """K1-K3 (K1, K2, K4 with a bf16 copy; K1, K5, K6) on 2 and 4 shards,
    even and uneven (an odd length), equal to the whole leaf's run within
    2e-5 (fp32; the bf16 copy within one bf16 ulp)."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g, m, v, x = KL.lans_case(n, torch.float32, seed=n_shards,
                              device=device)
    whole = _sharded_steps(g, m, v, x, 1, kind)
    cut = _sharded_steps(g, m, v, x, n_shards, kind)
    for a, b in zip(cut, whole):
        tol = (dict(rtol=2 ** -7, atol=1e-6) if a.dtype == torch.bfloat16
               else dict(rtol=2e-5, atol=2e-5))
        torch.testing.assert_close(a, b, **tol)


def test_sharded_lans_steps_without_a_cut_is_the_fused_step():
    """ops.sharded_lans_steps over whole leaves (key (), no reduction) is
    ops.fused_lans_step leaf by leaf, bit for bit, on the CPU."""
    leaves = [KL.lans_case(n, torch.float32, seed=n) for n in (7, 130, 4097)]
    rows = ops.lans_scalar_rows(0.02, 3, [True, False, True], beta1=0.9,
                                beta2=0.999, lam=0.01, device="cpu")
    never = lambda t, key: pytest.fail("a whole leaf was reduced")
    got = ops.sharded_lans_steps(
        [(*leaf, row) for leaf, row in zip(leaves, rows.clone().unbind(0))],
        [()] * 3, never)
    for leaf, row, out in zip(leaves, rows.unbind(0), got):
        want = ops.fused_lans_step(*leaf, scalars=row.clone())
        for a, b in zip(out, want):
            assert torch.equal(a, b)


def test_cuda_router_over_two_replicas_with_k8():
    """Needs the card: reduced gemma2-2b behind ReplicaRouter over two
    replicas sharing one params tree, each policy: the one engine's greedy
    tokens, and K8 launched decode steps x layers summed over the
    replicas."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import reduced_arch
    from repro_torch.serving import (ContinuousEngine, ReplicaRouter,
                                     Request)
    arch = reduced_arch("gemma2-2b")
    params = arch.init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(3)
    system = rng.integers(5, arch.cfg.vocab, size=16)
    prompts = [np.concatenate([system, rng.integers(
        5, arch.cfg.vocab, size=4 + i)]).astype(np.int32) for i in range(5)]
    prompts.append(rng.integers(5, arch.cfg.vocab, size=5).astype(np.int32))
    engine = lambda: ContinuousEngine(arch, params, max_batch=2, max_len=48,
                                      policy="fp32", block_size=8,
                                      prefill_bucket=8, attn_kernel="paged")
    runs = {}
    for policy in (None, "prefix", "depth", "rr"):
        eng = (engine() if policy is None
               else ReplicaRouter([engine(), engine()], policy=policy))
        reqs = [Request(prompt=p.copy(), max_new_tokens=6) for p in prompts]
        pa.paged_attention_fused.launches = 0
        eng.run(reqs)
        rep = eng.report(1.0)
        steps = sum(r["decode_steps"] for r in rep.get("per_replica", [rep]))
        assert pa.paged_attention_fused.launches == \
            steps * arch.cfg.n_layers > 0
        runs[policy] = [r.generated.tolist() for r in reqs]
        if policy == "prefix":
            # five prompts share a two-block system prompt, one is
            # shorter than a block
            assert rep["routed_fallback"] == 1
            assert rep["routed_affinity_hits"] == 4
    assert all(t == runs[None] for t in runs.values())


@pytest.mark.parametrize("pads", [0, 1000])
def test_cuda_moe_capacity_route_equals_the_cpu(pads):
    """models/moe.py's capacity positions at granite-moe-3b-a800m's
    training shape (16,384 tokens, top 8 of 40, one group): the card's
    device-wide scan gives the CPU's flat_e, pos_k, keep and density,
    equal (tests/port/test_torch_moe.py holds the CPU's against the
    token-dim cumsum)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.models import moe
    T, E, K = 16384, 40, 8
    gen = torch.Generator().manual_seed(pads)
    scores = torch.rand((1, T, E), generator=gen) + torch.linspace(1, 0, E)
    idx_k = moe._top_k(scores, K)[1]
    valid = torch.arange(T)[None] >= pads if pads else None
    cap = int(1.25 * T * K / E)
    want = moe._capacity_route(idx_k, E, cap, valid)
    got = moe._capacity_route(idx_k.cuda(), E, cap,
                              None if valid is None else valid.cuda())
    for name, w, g in zip(("flat_e", "pos_k", "keep", "density"), want, got):
        assert g.is_cuda and torch.equal(w, g.cpu()), name
    assert not want[2].all()


# --------------------------------------------------------------------------
# the mesh on four cards: NCCL, one rank per card, the model axis and zero3
# with K1-K6 on each rank's shards (tests/port/mesh_worker.py; on the CPU
# the same path runs under gloo in test_torch_mesh_train.py)
# --------------------------------------------------------------------------

from port import mesh_worker  # noqa: E402

FOUR_CARDS = {
    "2x2": dict(data=2, model=2, zero3=False, zero1=False),
    "2x2-zero3": dict(data=2, model=2, zero3=True, zero1=False),
    "1x4": dict(data=1, model=4, zero3=False, zero1=False),
}


@pytest.fixture(scope="module")
def four_card_runs(tmp_path_factory):
    """{layout: rank 0's results, ("ref", layout): the one-card runs,
    their gradients summed in the layout's order (mesh_worker.mesh_order:
    its data blocks, zero3's per-microbatch sums, its matmuls split)}:
    each layout's four ranks in turn, then the one-card references on
    card 0."""
    import multiprocessing
    from repro_torch import select_device
    from repro_torch.kernels import build
    select_device("cuda")
    build.build_all(["lans", "lamb"])      # once, before the ranks load it
    tmp = tmp_path_factory.mktemp("cards")
    params, cases = mesh_worker.port_inputs()
    inputs = tmp / "inputs.pt"
    torch.save({"params": params, "cases": cases}, inputs)
    ctx = multiprocessing.get_context("spawn")
    out = {}
    for name, layout in FOUR_CARDS.items():
        procs = mesh_worker.start_ranks(ctx, layout, tmp, inputs, name,
                                        device="cuda")
        out[name] = mesh_worker.join_ranks(procs, tmp, name, 300)
    dev = mesh_worker.to_device({"params": params, "cases": cases}, "cuda:0")
    for name, lay in FOUR_CARDS.items():
        out["ref", name] = {}
        for cname, case in dev["cases"].items():
            p = dev["params"][case["arch"]]
            early = (mesh_worker.early_paths(p, lay["data"], lay["model"])
                     if lay["zero3"] else frozenset())
            losses, got, *_ = mesh_worker.run_steps(
                case, p, case["batches"], data=lay["data"],
                model=lay["model"], zero3=lay["zero3"], early=early)
            out["ref", name][cname] = {
                "losses": losses, "params": mesh_worker.to_device(got, "cpu")}
    return out


@pytest.mark.parametrize("case", list(mesh_worker.ALL_CASES))
@pytest.mark.parametrize("layout", list(FOUR_CARDS))
def test_cuda_mesh_on_four_cards(request, layout, case):
    """Needs four cards: the cases of mesh_worker.ALL_CASES (reduced
    bert-large with fused_lans, fused_mixed_lans, fused_lamb, lans and
    adamw, qwen2.5-14b with 2 microbatches and with one KV head,
    granite-moe, whisper and mamba2; jamba, gemma2-2b with and without
    a forced chunked loss, granite-moe with five experts) on 2 x 2, 2 x
    2 with zero3 and 1 x 4 meshes over NCCL, 3 steps, against the
    one-card step in the layout's order (its experts, vocab and Mamba-2
    mixers split as the model ranks split them) with mesh_worker's
    tolerances; the fused optimizers' kernels launched on every step and
    leaf, their sums of squares added in one all-reduce per group of cut
    leaves and reduction."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    runs = request.getfixturevalue("four_card_runs")
    got = runs[layout][case]
    want = runs["ref", layout][case]
    mesh_worker.check_against_one_device(got, want, FOUR_CARDS[layout],
                                         case)
    arch, optimizer, _ = mesh_worker.ALL_CASES[case]
    n_leaves = len(want["params"])
    first = {"fused_lans": "lans_phase1", "fused_mixed_lans": "lans_phase1",
             "fused_lamb": "lamb_phase1"}.get(optimizer)
    if first is None:       # the unfused lans: no kernel, no partial sum
        assert got["calls"] == [0] * mesh_worker.STEPS
        assert not any(got["launches"].values())
        return
    assert got["launches"][first] == n_leaves * mesh_worker.STEPS
    # two reductions a step, over model (and data under zero3) groups
    groups = 2 if FOUR_CARDS[layout]["zero3"] else 1
    assert got["calls"][-1] >= 2 and got["calls"][-1] <= 2 * 2 * groups


# full width: BERT-large (fp32, seq 128, global batch 16, 2 fused_lans
# steps) on 2 x 2 and 1 x 4 with zero3, each rank's peak card memory
# against the one-card (1 x 1) step's
FULL_WIDTH = {
    "2x2-zero3": dict(data=2, model=2, zero3=True, zero1=False),
    "1x4-zero3": dict(data=1, model=4, zero3=True, zero1=False),
}


def test_cuda_mesh_full_width_memory_on_four_cards(tmp_path):
    """Needs four cards: every rank's peak under 2 x 2 and 1 x 4 with zero3
    is below the 1 x 1 step's (printed, per rank, for PERF.md)."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    import multiprocessing
    from repro_torch import select_device
    from repro_torch.kernels import build
    select_device("cuda")
    build.build_all(["lans"])
    one = mesh_worker.memory_step()
    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    for name, layout in FULL_WIDTH.items():
        procs = [ctx.Process(target=mesh_worker.run_memory_rank, args=(
            r, 4, str(tmp_path / f"store-{name}"), layout,
            str(tmp_path / f"out-{name}"))) for r in range(4)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(600)
            assert [p.exitcode for p in procs] == [0] * 4, name
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        peaks = [torch.load(tmp_path / f"out-{name}.{r}")["peak"]
                 for r in range(4)]
        print(f"full width BERT-large {name}: peak GB per rank "
              f"{[round(x / 1e9, 2) for x in peaks]} vs 1 x 1 "
              f"{one / 1e9:.2f} ({[round(x / one, 3) for x in peaks]})")
        assert max(peaks) < one, (name, peaks, one)


# --------------------------------------------------------------------------
# the serving engine on four cards over NCCL (tests/port/serve_worker.py;
# on the CPU the same cases run under gloo in test_torch_sharded_serving.py)
# --------------------------------------------------------------------------

from port import serve_worker  # noqa: E402

SERVE_FOUR_CARDS = {"1x4": dict(data=1, model=4),
                    "2x2": dict(data=2, model=2)}
SERVE_CASES = ["fp32", "kernel-fp32"]
# run on the same ranks: attention in two head groups of two ranks on 1 x
# 4 (reduced whisper and BERT with two heads), run_one, and on 2 x 2 three
# slots that do not divide over "data"; case -> its one-card case
GROUP_CASES = {"1x4": {"whisper-h2": "whisper-h2", "bert-h2": "bert-h2",
                       "one-fp32": "fp32"},
               "2x2": {"fp32-b3": "fp32-b3", "one-fp32": "fp32"}}


@pytest.fixture(scope="module")
def four_card_serving(tmp_path_factory):
    """{layout: every rank's results, "one": {case: the one-card run}}:
    reduced qwen2.5-14b, and whisper-large-v3 and bert-large with two
    heads (random weights from seed 0), each layout's four ranks in turn,
    then the one-card runs on card 0."""
    import multiprocessing
    from repro_torch import select_device
    from repro_torch.kernels import build
    select_device("cuda")
    build.build_all(["paged_attention"])   # once, before the ranks load it
    tmp = tmp_path_factory.mktemp("serve-cards")
    refs = {*SERVE_CASES, *(c for cases in GROUP_CASES.values()
                            for c in cases.values())}
    params = {a: serve_worker.reduced(a).init(
        torch.Generator().manual_seed(0))
        for a in {serve_worker.CASES[c]["arch"] for c in refs}}
    inputs = tmp / "params.pt"
    torch.save(params, inputs)
    ctx = multiprocessing.get_context("spawn")
    out = {}
    for name, layout in SERVE_FOUR_CARDS.items():
        procs = serve_worker.start(ctx, serve_worker.run_rank, 4, tmp, name,
                                   layout, SERVE_CASES + list(
                                       GROUP_CASES[name]), str(inputs),
                                   device="cuda")
        out[name] = serve_worker.join(procs, tmp, name, 300)
    dev = serve_worker.to_device(params, "cuda:0")
    out["one"] = {c: serve_worker.run_case(c, dev) for c in sorted(refs)}
    return out


@pytest.mark.parametrize("case", SERVE_CASES)
@pytest.mark.parametrize("layout", list(SERVE_FOUR_CARDS))
def test_cuda_serving_mesh_on_four_cards(request, layout, case):
    """Needs four cards: the serving engine on 1 x 4 (the MLP split over
    four ranks; reduced qwen's 4 heads and 2 KV heads do not divide over
    them, so attention runs in two head groups of two ranks, each rank
    holding its group's KV head) and 2 x 2 (two slots over "data", heads
    and MLP over "model") over NCCL, with the gather and with K8: greedy
    fp32 tokens equal one card's, every rank's host state equal, and K8
    launched decode steps x layers on every rank."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    runs = request.getfixturevalue("four_card_serving")
    want = runs["one"][case]
    assert serve_worker.ranks_agree(runs[layout], case)
    n_layers = serve_worker.case_arch(case).cfg.n_layers
    for rank in runs[layout]:
        got = rank[case]
        assert serve_worker.same_tokens(got["tokens"], want["tokens"])
        assert got["report"]["mesh_devices"] == 4
        if case == "kernel-fp32":
            assert got["launches"] == got["steps"] * n_layers > 0
        else:
            assert got["launches"] == 0


@pytest.mark.parametrize("layout,case", [(lay, c) for lay, cases in
                                         GROUP_CASES.items() for c in cases])
def test_cuda_serving_groups_on_four_cards(request, layout, case):
    """Needs four cards: over NCCL, reduced whisper-large-v3 and BERT
    scoring with two heads on 1 x 4 (two head groups of two ranks, each
    rank its group's K/V: half of one card's arena bytes), run_one on 1 x
    4 and 2 x 2, and on 2 x 2 three slots (whole on both data ranks):
    one card's tokens (BERT's ids; its pooled vectors within rtol 1e-4,
    atol 1e-6), every rank's host state equal."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    runs = request.getfixturevalue("four_card_serving")
    want = runs["one"][GROUP_CASES[layout][case]]
    assert serve_worker.ranks_agree(runs[layout], case)
    for rank in runs[layout]:
        got = rank[case]
        assert serve_worker.same_tokens(got["tokens"], want["tokens"])
        for x, y in zip(want["embeddings"], got["embeddings"]):
            if x is not None:
                np.testing.assert_allclose(y, x, rtol=1e-4, atol=1e-6)
        if case == "whisper-h2":
            kv = [p for p in got["shapes"] if p.rsplit("/", 1)[-1] in
                  ("k", "v")]
            assert kv
            for path in kv:
                assert got["shapes"][path][1] * 2 == \
                    want["shapes"][path][1], path


@pytest.mark.parametrize("case", ["qwen-fused_lans", "gemma2-fused_lans"])
def test_cuda_head_groups_gather_on_four_cards(request, case):
    """Needs four cards: on 1 x 4 over NCCL (the four-card runs above)
    reduced qwen2.5-14b and gemma2-2b (4 heads, 2 KV heads: two head
    groups of two ranks) gather wq / wk / wv over their group alone, at
    the group's columns, and nothing over all four ranks: wo, the MLP
    and the vocab stay the rank's shards."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    runs = request.getfixturevalue("four_card_runs")
    cfg = mesh_worker.reduced(mesh_worker.ALL_CASES[case][0]).cfg
    hd = cfg.resolved_head_dim
    want = {((cfg.d_model, n * hd // 2), (2,))
            for n in (cfg.n_heads, cfg.n_kv_heads)}
    got = {(tuple(s), tuple(g)) for s, g in runs["1x4"][case]["gathered"]}
    assert got == want
