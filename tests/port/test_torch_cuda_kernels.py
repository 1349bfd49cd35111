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
