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
import pytest
import torch

from repro_torch.kernels import paged_attention as pa


@pytest.mark.parametrize("layout,ok", [
    (dict(block_size=16, head_dim=256, n_heads=8, n_kv=4, S=1), True),
    (dict(block_size=16, head_dim=256, n_heads=8, n_kv=4, S=4), True),
    (dict(block_size=4, head_dim=64, n_heads=4, n_kv=2, S=8), False),
    (dict(block_size=64, head_dim=256, n_heads=32, n_kv=1, S=16), False),
    (dict(block_size=16, head_dim=64, n_heads=6, n_kv=4, S=1), False),
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
