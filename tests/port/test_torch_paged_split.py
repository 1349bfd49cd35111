"""The split-KV plan of the paged-attention kernels (K7/K8,
csrc/paged_attention.cu) on the CPU: the split plan, the shared-memory
plan and the layout limits the wrapper checks, and the kernels'
algorithm (per-split partial softmax states, K8's new rows folded by
split 0 with the stale rows masked, a combine in split order) written
out in PyTorch and held to the plain versions.

Tolerance: 1e-5 (atol and rtol) against the plain versions: fp32 on both
sides, summed in another order.
"""
import itertools
import pathlib
import re

import pytest
import torch

from repro_torch.kernels import paged_attention as pa

CU = (pathlib.Path(pa.__file__).parent / "csrc"
      / "paged_attention.cu").read_text()


def _cu_constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", CU).group(1))


@pytest.mark.parametrize("B,n_kv,nb", list(itertools.product(
    (1, 4, 16), (1, 4, 8), (1, 6, 64, 256, 1000))))
def test_split_plan_covers_every_entry_once(B, n_kv, nb):
    for n_sm in (132, 16):
        n_split, chunk, n_groups = pa.split_plan(nb, B, n_kv, n_sm)
        assert 1 <= n_split <= nb and 1 <= chunk <= pa.MAX_CHUNK
        assert 1 <= n_groups <= B
        covered = sorted(j for k in range(n_split)
                         for j in range(k, nb, n_split))
        assert covered == list(range(nb))
        # split k takes at most chunk entries, and no split is empty
        assert all(len(range(k, nb, n_split)) <= chunk
                   for k in range(n_split))
        assert n_split <= nb
        # every slot is in exactly one group
        assert sorted(b for z in range(n_groups)
                      for b in range(z, B, n_groups)) == list(range(B))
        # no more CTAs than the aim, unless one group of single-entry
        # splits already exceeds it
        ctas = pa.CTAS_PER_SM * n_sm
        assert n_split * n_kv * n_groups <= max(ctas, n_split * n_kv)


def test_split_plan_at_the_smoke_shapes():
    """4 slots x 4 KV heads on 132 SMs: the serving ring (6 blocks) gets
    one block per split and one slot per CTA, 96 CTAs instead of 16; the
    256-block ring 128 splits of 2 blocks a slot, each CTA over all 4
    slots, 512 CTAs."""
    assert pa.split_plan(6, 4, 4, 132) == (6, 1, 4)
    assert pa.split_plan(256, 4, 4, 132) == (128, 2, 1)


def test_smem_bytes_is_the_kernel_plan():
    """smem_bytes counts the regions the .cu carves, in its order: the
    mbarriers, the K and V rings of kStages blocks in the arena dtype,
    the q ring and the folded slot's q (4 bytes an element), fp32 acc per
    key group and row, the ring's int32 key positions and records, fp32 m
    and l per key group and row, and the rows' int32 query positions. The
    key groups are all four warps where that fits (the serving and
    S = 4 verify layouts), two at S = 16 with gemma2-2b's heads."""
    assert pa.STAGES == _cu_constant("kStages")
    assert pa.WARPS == _cu_constant("kThreads") // 32
    for S, h, n_kv, hd, bs, dtype, esz, groups in (
            (1, 8, 4, 256, 16, torch.bfloat16, 2, 4),
            (4, 8, 4, 256, 16, torch.float32, 4, 4),
            (3, 4, 2, 16, 8, torch.bfloat16, 2, 4),
            (16, 8, 4, 256, 16, torch.float32, 4, 2),
            (16, 8, 4, 256, 16, torch.bfloat16, 2, 2)):
        assert pa.key_groups(S, h, n_kv, hd, bs, dtype) == groups
        R = S * h // n_kv
        regions = [("barriers", -(-pa.STAGES * 8 // 16) * 16),
                   ("k ring", pa.STAGES * bs * hd * esz),
                   ("v ring", pa.STAGES * bs * hd * esz),
                   ("q ring", pa.STAGES * R * hd * 4), ("q", R * hd * 4),
                   ("acc", groups * R * hd * 4),
                   ("key pos", pa.STAGES * bs * 4),
                   ("meta", pa.STAGES * (4 + S) * 4),
                   ("m", groups * R * 4), ("l", groups * R * 4),
                   ("q pos", R * 4)]
        assert pa.smem_bytes(S, h, n_kv, hd, bs, dtype) == sum(
            n for _, n in regions) <= pa.SMEM_LIMIT
        # every region a bulk copy fills starts 16-byte aligned: the K
        # and V rings, q and the key positions
        offsets = dict(zip([n for n, _ in regions], itertools.accumulate(
            [0] + [n for _, n in regions])))
        for name in ("k ring", "v ring", "q ring", "q", "acc", "key pos"):
            assert offsets[name] % 16 == 0, name
    # gemma2-2b's serving layout: 47,360 bytes, four CTAs per SM
    assert pa.smem_bytes(1, 8, 4, 256, 16, torch.bfloat16) == 47360
    assert pa.CTAS_PER_SM * 47360 <= pa.SMEM_LIMIT


@pytest.mark.parametrize("layout,k8,k7", [
    (dict(block_size=16, head_dim=256, n_heads=8, n_kv=4, S=1), True, True),
    (dict(block_size=16, head_dim=128, n_heads=8, n_kv=4, S=16), True, True),
    (dict(block_size=16, head_dim=128, n_heads=8, n_kv=4, S=17), False,
     True),
    (dict(block_size=16, head_dim=256, n_heads=8, n_kv=4, S=16), True,
     True),
    (dict(block_size=16, head_dim=12, n_heads=8, n_kv=4, S=1), False, False),
    (dict(block_size=6, head_dim=64, n_heads=8, n_kv=4, S=1), False, False),
    (dict(block_size=64, head_dim=256, n_heads=64, n_kv=1, S=4), False,
     False),
])
def test_fit_limits_of_the_split_tiling(layout, k8, k7):
    """head_dim a multiple of 8 (16-byte rows) and block_size of 4
    (16-byte position rows); K8's S at most a block
    (its new rows share a block buffer), K7's S free; the shared-memory
    plan within 227 KB."""
    layout = dict(layout)
    args = (layout.pop("block_size"), layout.pop("head_dim"),
            layout.pop("n_heads"), layout.pop("n_kv"), torch.bfloat16)
    assert (pa.kernel_fit_problems(*args, **layout) == []) == k8
    assert (pa.kernel_fit_problems(*args, **layout, new_rows=False)
            == []) == k7


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k8_takes_a_block_of_rows_at_gemma2_heads(dtype):
    """K8 takes every S <= block_size (16) at gemma2-2b's heads (8 / 4,
    head_dim 256), as the reference does, with fp32 and bf16 arenas: the
    rows that do not fit four fp32 states each per row (S >= 12 with fp32
    arenas, 14 with bf16) fold with two key groups. S > block_size stays
    refused, as the reference's block-buffer rule refuses it."""
    for S in range(1, 17):
        assert pa.kernel_fit_problems(16, 256, 8, 4, dtype, S=S) == [], S
        want = 4 if S < (12 if dtype == torch.float32 else 14) else 2
        assert pa.key_groups(S, 8, 4, 256, 16, dtype) == want, S
    assert pa.kernel_fit_problems(16, 256, 8, 4, dtype, S=17)


def _split_kv(args, *, scale, window, softcap, n_split, chunk, new_rows):
    """The kernels' algorithm in PyTorch: per (slot, KV head, split) the
    partial (m, l, acc) of the R query rows over the split's table
    entries (split k: entries k, k + n_split, ...), with the rows the new
    rows overwrite masked (K8, whose
    split 0 folds the S new rows alone), then the partials merged in a
    fixed order. Reads the arenas before the write; returns the output
    only."""
    q, k_new, v_new, k, v, pos, tables, q_pos, cursor = args
    B, S, h, hd = q.shape
    bs, n_kv = k.shape[1], k.shape[2]
    G, nb = h // n_kv, tables.shape[1]
    ring = nb * bs
    out = torch.zeros(B, S, h, hd)
    qp = q_pos[:, :, None].expand(B, S, G).reshape(B, S * G)
    for b, g in itertools.product(range(B), range(n_kv)):
        qr = q[b, :, g * G:(g + 1) * G].reshape(S * G, hd).float()
        parts = []
        # K8: split 0 folds the new rows alone, table split s is partial
        # s + 1
        for s in range(-int(new_rows), n_split):
            keys, vals, kpos = [], [], []
            if s < 0:
                for t in range(S):
                    rr = (int(cursor[b]) + t) % ring
                    keys.append(k_new[b, t, g].float())
                    vals.append(v_new[b, t, g].float())
                    kpos.append(int(q_pos[b, t]) if tables[b, rr // bs]
                                else -1)
            for j in (range(s, nb, n_split) if s >= 0 else ()):
                blk = int(tables[b, j])
                if blk == 0:
                    continue
                for t in range(bs):
                    kp = int(pos[blk, t])
                    dl = (j * bs + t - int(cursor[b])) % ring
                    if new_rows and dl < S and q_pos[b, dl] >= 0:
                        kp = -1
                    keys.append(k[blk, t, g].float())
                    vals.append(v[blk, t, g].float())
                    kpos.append(kp)
            if not keys:
                parts.append((torch.full((S * G,), -torch.inf),
                              torch.zeros(S * G), torch.zeros(S * G, hd)))
                continue
            kp = torch.tensor(kpos)
            x = qr @ torch.stack(keys).T * scale
            if softcap:
                x = softcap * torch.tanh(x / softcap)
            ok = (kp[None] >= 0) & (kp[None] <= qp[b][:, None])
            if window:
                ok &= (qp[b][:, None] - kp[None]) < window
            x = torch.where(ok, x, -torch.inf)
            m = x.max(dim=1).values
            e = torch.where(ok, torch.exp(x - m[:, None]), 0.0)
            parts.append((m, e.sum(dim=1), e @ torch.stack(vals)))
        M = torch.stack([p[0] for p in parts]).max(dim=0).values
        acc, L = torch.zeros(S * G, hd), torch.zeros(S * G)
        for m, l, a in parts:
            w = torch.where(m == -torch.inf, 0.0, torch.exp(m - M))
            acc += w[:, None] * a
            L += w * l
        o = torch.where(L[:, None] > 0, acc / L[:, None], 0.0)
        out[b, :, g * G:(g + 1) * G] = o.reshape(S, G, hd)
    return out


@pytest.mark.parametrize("n_sm", [1, 4, 132])
@pytest.mark.parametrize("null_write", [False, True])
@pytest.mark.parametrize("window", [None, 20])
@pytest.mark.parametrize("S", [1, 4])
def test_split_kv_algorithm_matches_plain(S, window, null_write, n_sm):
    """The split-KV algorithm, at the split plans of cards with 1, 4 and
    132 SMs (1, a few and one entry per split), equals K8's and K7's
    plain versions: K8's split 0 folds the new rows, rows they overwrite are
    masked in whichever split streams them, a null new row is dropped,
    and splits with nothing valid weigh nothing."""
    args = pa.decode_case(B=4, S=S, n_heads=4, n_kv=2, head_dim=16,
                          block_size=8, nb=8, dtype=torch.float32,
                          device="cpu", seed=S + 2 * bool(window),
                          null_write=null_write)
    kw = dict(scale=0.25, window=window, softcap=5.0)
    n_split, chunk, _ = pa.split_plan(8, 4, 2, n_sm)
    plan = dict(n_split=n_split, chunk=chunk)
    before = [a.clone() for a in args]
    got7 = _split_kv(before, **kw, **plan, new_rows=False)
    want7 = pa.paged_attention_plain(*_read(before), **kw)
    torch.testing.assert_close(got7, want7, rtol=1e-5, atol=1e-5)
    got8 = _split_kv(before, **kw, **plan, new_rows=True)
    want8 = pa.paged_attention_fused_plain(*args, **kw)
    torch.testing.assert_close(got8, want8, rtol=1e-5, atol=1e-5)
    assert (got8[-1] == 0).all() and (got7[-1] == 0).all()


def _read(args):
    q, _, _, k, v, pos, tables, q_pos, _ = args
    return q, k, v, pos, tables, q_pos
