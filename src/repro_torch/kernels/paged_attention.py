"""Paged decode attention: K8 with the K/V/pos write fused in, and K7,
its read side.

`paged_attention_fused` (K8) is the wrapper the model calls once per
attention layer per decode step. On CUDA tensors it launches the
hand-written kernels of `csrc/paged_attention.cu` (which replace the TPU
kernel `repro/kernels/paged_attention_kernel.py:paged_attention_fused`);
on CPU tensors it runs `paged_attention_fused_plain`, the plain PyTorch
version both are held to. Either way the arenas are updated IN PLACE
(the JAX kernel aliased them in and out) and the attention output is
returned.

`paged_attention` (K7, replacing the TPU kernel `paged_attention`) is
the library entry of the read side: attention of q against arenas that
already hold the new rows, nothing written. Its kernels are K8's without
the new rows and the writes; its plain version is
`paged_attention_plain`. No model path calls it (the reference's only
caller is its kernel benchmark).

On the card a call is two launches (split KV, or flash-decoding). The
first runs one CTA per (table split, KV head, slot group): `split_plan`
deals each slot's table entries to splits (split k: entries k, k +
n_split, ...) and the slots to groups from the shapes and the SM count
alone, so that every CTA streams about as many blocks whichever slots
are long, short or dead. Each CTA streams its blocks with bulk copies
(TMA) through a ring of shared-memory buffers and folds each block, four
warps over its keys, into fp32 online-softmax states; it merges them
into one partial per slot and row (K8 adds a split that folds the new
rows). The second launch, started early (programmatic dependent
launch), merges the partials in a fixed order (the output repeats bit
for bit) and, for K8, writes the new K/V rows and positions once the
first launch has finished reading. The wrapper allocates the partials'
scratch; `smem_bytes` is the first launch's shared-memory plan and
`kernel_fit_problems` its limits.

`paged_cost` is a call's cost (FLOPs and the bytes it must move), read
by chip_smoke.py's bounds (with `paged_counts` of the call's tables) and
by the dry run: on meta tensors the wrappers run a stand-in that
charges it (launch/trace_cost.py), every table entry counted live.

Contract (the same as the JAX kernel's):
  q (B, [S,] h, hd) fp32, bf16 or fp16 (fp16 serving's queries); k_new / v_new (B, [S,] n_kv, hd) in
  the arena dtype; arenas (n_blocks, bs, n_kv, hd) fp32 or bf16; pos
  (n_blocks, bs) int32 with -1 marking an invalid row; tables (B, nb)
  int32 with 0 the null block; q_pos (B, [S]) int32; cursor (B,) int32.
  All arithmetic is fp32 and the output is fp32. A key is valid when its
  position is >= 0, <= the query's position (causal) and within
  `window` of it; logits are capped as softcap * tanh(x / softcap). A
  query row with no valid key returns exactly 0. Row s of slot b is
  written at ring row r = (cursor[b] + s) % (nb * bs), i.e. at
  arena[tables[b, r // bs], r % bs], with pos = q_pos[b, s]; rows with
  q_pos < 0 write nothing, and block 0 is never written.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import NEG_INF
from repro_torch.kernels.optim_common import stand_in

# Shared memory a Hopper block may use (dynamic, after opting in).
SMEM_LIMIT = 232448
# csrc/paged_attention.cu's kStages (blocks of K/V in the ring of a split
# CTA) and kWarps (warps of a CTA).
STAGES = 2
WARPS = 4
# Split CTAs aimed at per SM: a bf16 CTA of gemma2-2b's serving layout
# takes ~46 KB of shared memory, so four fit on one SM.
CTAS_PER_SM = 4
# Table entries of one split at most: a split CTA keeps them one per lane.
MAX_CHUNK = 32
_FLOAT_TYPES = (torch.float32, torch.bfloat16)     # arena dtypes
# q's dtype -> csrc/paged_attention.cu's QType code
Q_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def split_plan(nb: int, B: int, n_kv: int, n_sm: int) -> tuple:
    """(n_split, chunk, n_groups) for B slots with tables of nb entries
    and n_kv KV heads on a card of n_sm SMs. Split k takes the entries
    k, k + n_split, ... (chunk of them at most, at most MAX_CHUNK) of a
    slot's table: together the splits cover each entry once, and the null
    entries at the end of a short slot's table spread over all of them.
    A split CTA takes the slots z, z + n_groups, ... of its group z, so
    that CTAs of long, short and dead slots do about the same work. Aims
    at CTAS_PER_SM CTAs per SM: as many splits as that allows (never
    more than entries), then slot groups for what is left. Depends on the
    shapes and the SM count only, never on the tables' contents."""
    ctas = CTAS_PER_SM * n_sm
    n_split = max(1, min(nb, max(-(-ctas // n_kv), -(-nb // MAX_CHUNK))))
    chunk = max(1, -(-nb // n_split))
    n_split = max(1, -(-nb // chunk))
    n_groups = max(1, min(B, ctas // (n_split * n_kv)))
    return n_split, chunk, n_groups


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """cudaDevAttrMultiProcessorCount of the card."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def smem_bytes(S: int, n_heads: int, n_kv: int, head_dim: int,
               block_size: int, dtype, groups: Optional[int] = None) -> int:
    """Dynamic shared memory, in bytes, of one split CTA: the plan carved
    in csrc/paged_attention.cu (STAGES mbarriers rounded up to 16 bytes; a
    ring of STAGES blocks of K and of V in the arena dtype; a ring of
    STAGES copies of the R = S * n_heads / n_kv query rows and the rows
    being folded, 4 bytes an element (whatever q's dtype); an accumulator per
    key group and row in fp32; the ring's key positions and STAGES
    records of 4 + S ints; a running max and sum per key group and row in
    fp32; the rows' query positions). `groups` is the number of key
    groups (default: key_groups's choice). The wrapper passes it to the
    launch."""
    if groups is None:
        groups = key_groups(S, n_heads, n_kv, head_dim, block_size, dtype)
    R = S * (n_heads // n_kv)
    esz = torch.empty((), dtype=dtype).element_size()
    return (-(-STAGES * 8 // 16) * 16
            + 2 * STAGES * block_size * head_dim * esz
            + ((STAGES + 1) * R * head_dim + groups * R * head_dim) * 4
            + (STAGES * block_size + STAGES * (4 + S)) * 4
            + 2 * groups * R * 4 + R * 4)


def key_groups(S: int, n_heads: int, n_kv: int, head_dim: int,
               block_size: int, dtype) -> int:
    """Warps of a split CTA that share out each query row's keys: WARPS
    (each warp keeps its own fp32 state of every row and folds every
    WARPS-th key tile) where that plan fits the shared memory, else
    WARPS / 2 (the warps then also split the rows two ways, so that each
    row has two states; kernel_fit_problems says whether that fits). At
    gemma2-2b's heads (8 / 4, head dim 256, block 16) S <= 11 (fp32
    arenas) or 13 (bf16) keep all four; S up to 16 takes 2."""
    if smem_bytes(S, n_heads, n_kv, head_dim, block_size, dtype,
                  WARPS) <= SMEM_LIMIT:
        return WARPS
    return WARPS // 2


def kernel_fit_problems(block_size: int, head_dim: int, n_heads: int,
                        n_kv: int, dtype, *, S: int = 1,
                        new_rows: bool = True) -> list:
    """Why this layout does not fit the kernel's tiling (empty: fits).

    One split CTA holds the S * (n_heads / n_kv) query rows of one KV
    head and a ring of STAGES arena blocks of K and V in shared memory,
    copied in 16-byte pieces, so a K/V row (head_dim elements) must be a
    multiple of 8 elements and a block's positions (block_size int32) a
    multiple of 4. K8 (new_rows) reuses a block buffer for the
    S new rows, so S may not exceed block_size there; K7 folds no new
    rows."""
    problems = []
    if dtype not in _FLOAT_TYPES:
        problems.append(f"arena dtype {dtype} is not float32 or bfloat16")
        return problems
    if n_kv <= 0 or n_heads % n_kv:
        problems.append(f"n_heads {n_heads} is not a multiple of n_kv {n_kv}")
        return problems
    if head_dim % 8:
        problems.append(f"head_dim {head_dim} is not a multiple of 8: the "
                        f"kernel copies K/V rows in 16-byte pieces")
    if block_size % 4:
        problems.append(f"block_size {block_size} is not a multiple of 4: "
                        f"the kernel copies a block's positions in 16-byte "
                        f"pieces")
    if S < 1 or (new_rows and S > block_size):
        problems.append(f"S={S} query rows must be in [1, block_size "
                        f"{block_size}]: the kernel folds the new rows in "
                        f"a block buffer")
    smem = smem_bytes(S, n_heads, n_kv, head_dim, block_size, dtype)
    if smem > SMEM_LIMIT:
        problems.append(f"shared memory {smem} bytes (two key groups) "
                        f"exceeds the {SMEM_LIMIT}-byte limit: shrink "
                        f"block_size or S")
    return problems


def ensure_kernel_fit(block_size: int, head_dim: int, n_heads: int,
                      n_kv: int, dtype, *, S: int = 1, new_rows: bool = True,
                      device="cpu") -> list:
    """Raise, for a CUDA device, on a layout the kernel (K8, or K7 without
    new_rows) cannot take. Returns the problem list; on the CPU (the
    plain versions take any layout) the problems are advisory."""
    problems = kernel_fit_problems(block_size, head_dim, n_heads, n_kv,
                                   dtype, S=S, new_rows=new_rows)
    if problems and torch.device(device).type == "cuda":
        raise ValueError("paged-attention kernel cannot take this layout: "
                         + "; ".join(problems))
    return problems


# --------------------------------------------------------------------------
# plain PyTorch version (mirrors repro/kernels/ref.py)
# --------------------------------------------------------------------------

def paged_attention_plain(q, k_arena, v_arena, pos_arena, tables, q_pos, *,
                          scale, causal: bool = True,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None):
    """Dense-gather attention over post-write arenas. q (B, S, h, hd),
    q_pos (B, S); returns (B, S, h, hd) fp32."""
    B, S, h, hd = q.shape
    n_kv = k_arena.shape[2]
    ring = tables.shape[1] * k_arena.shape[1]
    tbl = tables.long()
    k = k_arena[tbl].reshape(B, ring, n_kv, hd).float()
    v = v_arena[tbl].reshape(B, ring, n_kv, hd).float()
    kp = pos_arena[tbl].reshape(B, ring)
    if n_kv != h:
        k = k.repeat_interleave(h // n_kv, dim=2)
        v = v.repeat_interleave(h // n_kv, dim=2)
    logits = torch.einsum("bshd,bkhd->bshk", q.float(), k) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    ok = (kp >= 0)[:, None, :].expand(B, S, ring)
    qp = q_pos[:, :, None]
    if causal:
        ok = ok & (kp[:, None, :] <= qp)
    if window is not None:
        ok = ok & ((qp - kp[:, None, :]) < window)
    logits = torch.where(ok[:, :, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bshk,bkhd->bshd", probs, v)
    live = ok.any(dim=2)
    return torch.where(live[:, :, None, None], out, 0.0)


def paged_attention_fused_plain(q, k_new, v_new, k_arena, v_arena,
                                pos_arena, tables, q_pos, cursor, *,
                                scale, causal: bool = True,
                                window: Optional[int] = None,
                                softcap: Optional[float] = None):
    """Write the new rows into the arenas (in place), then attend — the
    plain version of the kernel, mirroring
    repro/kernels/ref.py:paged_attention_fused_ref."""
    squeeze = q.ndim == 3
    if squeeze:
        q, q_pos = q[:, None], q_pos[:, None]
        k_new, v_new = k_new[:, None], v_new[:, None]
    S = q.shape[1]
    bs = k_arena.shape[1]
    ring = tables.shape[1] * bs
    r = (cursor.long()[:, None]
         + torch.arange(S, device=cursor.device)) % ring
    blk = torch.gather(tables.long(), 1, r // bs)
    off = r % bs
    w = (q_pos >= 0) & (blk != 0)          # null block 0 is never written
    k_arena[blk[w], off[w]] = k_new[w].to(k_arena.dtype)
    v_arena[blk[w], off[w]] = v_new[w].to(v_arena.dtype)
    pos_arena[blk[w], off[w]] = q_pos[w].to(pos_arena.dtype)
    out = paged_attention_plain(q, k_arena, v_arena, pos_arena, tables,
                                q_pos, scale=scale, causal=causal,
                                window=window, softcap=softcap)
    return out[:, 0] if squeeze else out


def decode_case(*, B: int, S: int, n_heads: int, n_kv: int, head_dim: int,
                block_size: int, nb: int, dtype=torch.bfloat16,
                q_dtype=torch.float32, device="cpu", seed: int = 0,
                null_write: bool = False):
    """Pool-shaped inputs for checking the kernel against its plain
    version, in the argument order of paged_attention_fused (q (B, S, h,
    hd), ...). Slot b owns blocks 1 + b*nb .. (b+1)*nb as the allocator
    would give them; slot 0's history has wrapped its ring, slot 1 backs
    only half its table (the rest is the null block), the last slot is
    dead (all-null table, q_pos -1), and ~10% of history rows carry
    position -1. For S > 1 the last query row of slot 1 is padding
    (q_pos -1). Query positions equal the cursors, as in the engine.
    With null_write, slot 1's cursor sits at the end of its backed half
    so that one of its valid new rows lands on a null table entry: a
    state the engine never makes (it backs a row before writing it), in
    which the row is neither written nor attended to."""
    rng = np.random.default_rng(seed)
    ring = nb * block_size
    n_blocks = 1 + B * nb
    tables = np.zeros((B, nb), np.int32)
    for b in range(B - 1):
        tables[b] = 1 + b * nb + np.arange(nb)
    if B > 2:
        tables[1, nb // 2:] = 0
    cursor = np.array([2 * ring - 2] + [ring // 3 + 5 * b
                                        for b in range(1, B)], np.int32)
    if B > 2:   # slot 1 writes at the end of its backed half
        cursor[1] = max(0, (nb // 2) * block_size
                        - (S // 2 if null_write else S))
    pos = np.full((n_blocks, block_size), -1, np.int32)
    for b in range(B - 1):
        for p in range(max(0, cursor[b] - ring), cursor[b]):
            blk = tables[b, (p % ring) // block_size]
            if blk and rng.random() > 0.1:
                pos[blk, p % block_size] = p
    q_pos = (cursor[:, None] + np.arange(S)).astype(np.int32)
    q_pos[-1] = -1
    if S > 1 and B > 2:
        q_pos[1, -1] = -1
    shp = dict(q=(B, S, n_heads, head_dim), k_new=(B, S, n_kv, head_dim),
               v_new=(B, S, n_kv, head_dim),
               k_arena=(n_blocks, block_size, n_kv, head_dim),
               v_arena=(n_blocks, block_size, n_kv, head_dim))
    out = [torch.from_numpy(rng.standard_normal(shp[k], np.float32)).to(
        device=device, dtype=q_dtype if k == "q" else dtype)
        for k in ("q", "k_new", "v_new", "k_arena", "v_arena")]
    return out + [torch.from_numpy(a).to(device)
                  for a in (pos, tables, q_pos, cursor)]


def verify_case(*, S: int, n_heads: int, n_kv: int, head_dim: int,
                block_size: int, nb: int, dtype=torch.bfloat16,
                q_dtype=torch.float32, device="cpu", seed: int = 0):
    """The operands of a speculative verify step (S query rows in each of
    4 slots) as the engine's paged pool makes them, in the argument order
    of paged_attention_fused. Each table has nb entries: nb - 1 blocks of
    rows plus the row margin's block. Slot b owns blocks 1 + b*nb ..
    (b+1)*nb; its history holds positions 0..cursor-1 (~10% at -1), rows
    from the cursor on are -1 (fresh or rolled back), and only blocks
    that rows of this round or the next reach are backed. The first
    fl[b] query rows are real (q_pos = cursor + s), the rest -1, as in a
    round cut short by the budget: slot 0 writes the last two rows before
    the margin (fl = min(S, 2); its margin entry is null, so its padding
    rows fall on it), slot 1 has one padding row, slot 2 a full round and
    slot 3 is dead. Returns (operands, fl)."""
    rng = np.random.default_rng(seed)
    B, bs = 4, block_size
    ring = nb * bs
    rows = (nb - 1) * bs
    cursor = np.array([rows - 2, rows // 2 - 3, 5, 0], np.int32)
    fl = np.array([min(S, 2), S - 1, S, 0], np.int32)
    tables = np.zeros((B, nb), np.int32)
    pos = np.full((1 + B * nb, bs), -1, np.int32)
    for b in range(B - 1):
        reach = nb - 1 if b == 0 else min(nb, -(-(cursor[b] + 2 * S) // bs))
        tables[b, :reach] = 1 + b * nb + np.arange(reach)
        for p in range(cursor[b]):
            if rng.random() > 0.1:
                pos[tables[b, p // bs], p % bs] = p
    q_pos = np.full((B, S), -1, np.int32)
    for b in range(B - 1):
        q_pos[b, :fl[b]] = cursor[b] + np.arange(fl[b])
    assert ring >= rows + S - 1, "the margin block must hold S - 1 rows"
    shp = dict(q=(B, S, n_heads, head_dim), k_new=(B, S, n_kv, head_dim),
               v_new=(B, S, n_kv, head_dim),
               k_arena=(1 + B * nb, bs, n_kv, head_dim),
               v_arena=(1 + B * nb, bs, n_kv, head_dim))
    out = [torch.from_numpy(rng.standard_normal(shp[k], np.float32)).to(
        device=device, dtype=q_dtype if k == "q" else dtype)
        for k in ("q", "k_new", "v_new", "k_arena", "v_arena")]
    return out + [torch.from_numpy(a).to(device)
                  for a in (pos, tables, q_pos, cursor)], fl


# --------------------------------------------------------------------------
# the wrappers
# --------------------------------------------------------------------------

def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _library():
    from repro_torch.kernels import build
    lib = build.load("paged_attention")
    if lib.paged_attention_fused_launch.argtypes is None:
        P, I, F, Z = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_size_t)
        lib.paged_attention_fused_launch.argtypes = [
            P, I, P, P, P, P, I, P, P, P, P, P, P,
            I, I, I, I, I, I, I, I, I, I, I, F, I, I, F, Z, P]
        lib.paged_attention_launch.argtypes = [
            P, I, P, P, I, P, P, P, P, P,
            I, I, I, I, I, I, I, I, I, I, I, F, I, I, F, Z, P]
        for fn in (lib.paged_attention_fused_launch,
                   lib.paged_attention_launch):
            fn.restype = I
    return lib


def _check(name, t, device, dtypes, shape):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of "
                        f"{dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _launch(wrapper, q, k_new, v_new, k_arena, v_arena, pos_arena, tables,
            q_pos, cursor, *, scale, causal, window, softcap):
    """Check the operands (q (B, S, h, hd); k_new, v_new and cursor None
    for K7), launch K8 or K7 on q's stream and return the fp32 output
    (B, S, h, hd). Adds one to `wrapper.launches` once the launch has
    succeeded; an empty batch launches nothing and counts nothing."""
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    if q.ndim != 4 or k_arena.ndim != 4:
        raise ValueError("q must be (B, [S,] h, hd) and the arenas "
                         "(n_blocks, bs, n_kv, hd)")
    B, S, h, hd = q.shape
    n_blocks, bs, n_kv, _ = k_arena.shape
    nb = tables.shape[1] if tables.ndim == 2 else -1
    dev = q.device
    kv_dt = k_arena.dtype
    i32 = (torch.int32,)
    _check("q", q, dev, tuple(Q_CODES), (B, S, h, hd))
    _check("k_arena", k_arena, dev, _FLOAT_TYPES, (n_blocks, bs, n_kv, hd))
    _check("v_arena", v_arena, dev, (kv_dt,), (n_blocks, bs, n_kv, hd))
    new_rows = k_new is not None
    if new_rows:
        _check("k_new", k_new, dev, (kv_dt,), (B, S, n_kv, hd))
        _check("v_new", v_new, dev, (kv_dt,), (B, S, n_kv, hd))
        _check("cursor", cursor, dev, i32, (B,))
    _check("pos_arena", pos_arena, dev, i32, (n_blocks, bs))
    _check("tables", tables, dev, i32, (B, nb))
    _check("q_pos", q_pos, dev, i32, (B, S))
    ensure_kernel_fit(bs, hd, h, n_kv, kv_dt, S=S, new_rows=new_rows,
                      device=dev)
    for name, t in (("q", q), ("k_arena", k_arena), ("v_arena", v_arena),
                    ("k_new", k_new), ("v_new", v_new),
                    ("pos_arena", pos_arena)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned: the kernel "
                             f"copies its rows in 16-byte pieces")
    out = torch.empty((B, S, h, hd), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    lib = _library()
    n_split, chunk, n_groups = split_plan(nb, B, n_kv, _sm_count(dev.index))
    n_split += int(new_rows)          # K8's split of the new rows
    R = S * (h // n_kv)
    part = torch.empty(B * n_kv * n_split * R * (hd + 2),
                       dtype=torch.float32, device=dev)
    groups = key_groups(S, h, n_kv, hd, bs, kv_dt)
    common = (B, S, h, n_kv, hd, bs, nb, n_split, chunk, n_groups, groups,
              float(scale), int(bool(causal)), int(window or 0),
              float(softcap or 0.0),
              smem_bytes(S, h, n_kv, hd, bs, kv_dt, groups),
              ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    q_type, kv_bf16 = Q_CODES[q.dtype], int(kv_dt == torch.bfloat16)
    if new_rows:
        err = lib.paged_attention_fused_launch(
            _ptr(q), q_type, _ptr(k_new), _ptr(v_new), _ptr(k_arena),
            _ptr(v_arena), kv_bf16, _ptr(pos_arena), _ptr(tables),
            _ptr(q_pos), _ptr(cursor), _ptr(out), _ptr(part), *common)
    else:
        err = lib.paged_attention_launch(
            _ptr(q), q_type, _ptr(k_arena), _ptr(v_arena), kv_bf16,
            _ptr(pos_arena), _ptr(tables), _ptr(q_pos), _ptr(out),
            _ptr(part), *common)
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__} launch failed: "
                           f"cudaError_t {err}")
    wrapper.launches += 1
    return out


def paged_counts(tables, q_pos) -> dict:
    """What a call's cost depends on in its data: the distinct non-null
    blocks its tables reference, its non-null table entries and its
    valid query rows."""
    return dict(blocks=int(tables[tables != 0].unique().numel()),
                entries=int((tables != 0).sum()),
                n_new=int((q_pos >= 0).sum()))


def paged_cost(q, k_arena, tables, q_pos, *, blocks, entries, k_new=None,
               cursor=None, n_new=0):
    """(FLOPs, bytes) of one K7 call (k_new None) or K8 call, q (B, S, h,
    hd): each referenced block's K, V and positions read once, q, the
    tables and q_pos read once, the fp32 output written once, and K8's
    new rows and cursors read and its valid rows (K, V, position)
    written; 4 FLOPs per (query row, key, head dim) for QK^T and PV, over
    `entries` table entries of block_size keys each (K8 also attends to
    its S new rows). The FLOPs are fp32, outside the tensor cores."""
    B, S, h, _ = q.shape
    _, bs, n_kv, hd = k_arena.shape
    esz = k_arena.element_size()
    nbytes = (blocks * (2 * bs * n_kv * hd * esz + bs * 4)
              + q.numel() * q.element_size()
              + 4 * (tables.numel() + q_pos.numel()) + q.numel() * 4)
    keys = entries * bs
    if k_new is not None:
        nbytes += (2 * k_new.numel() * esz + 4 * cursor.numel()
                   + n_new * (2 * n_kv * hd * esz + 4))
        keys += S * B
    return 4 * h * hd * S * keys, nbytes


def _stand_in(wrapper, q, k_arena, tables, q_pos, k_new=None, cursor=None):
    """A meta call's output (B, S, h, hd) fp32, its cost charged with every
    table entry live (at most the arena's non-null blocks) and every
    query row valid."""
    from repro_torch.launch.trace_cost import charge_kernel
    flops, nbytes = paged_cost(
        q, k_arena, tables, q_pos,
        blocks=min(tables.numel(), k_arena.shape[0] - 1),
        entries=tables.numel(), k_new=k_new, cursor=cursor,
        n_new=q_pos.numel())
    charge_kernel(wrapper.__name__, {"float32": flops}, nbytes)
    return torch.empty(q.shape, dtype=torch.float32, device=q.device)


def _on_cuda(q):
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"no paged-attention kernel for {q.device}")
    return True


def paged_attention_fused(q, k_new, v_new, k_arena, v_arena, pos_arena,
                          tables, q_pos, cursor, *, scale,
                          causal: bool = True, window: Optional[int] = None,
                          softcap: Optional[float] = None):
    """K8: attention output (fp32, shaped like q) of the new rows against
    the slot's paged history; the arenas are updated in place. CPU tensors
    run the plain version; CUDA tensors launch the kernel or raise.
    `paged_attention_fused.launches` counts kernel launches."""
    kw = dict(scale=scale, causal=causal, window=window, softcap=softcap)
    if not stand_in(q) and not _on_cuda(q):
        return paged_attention_fused_plain(
            q, k_new, v_new, k_arena, v_arena, pos_arena, tables, q_pos,
            cursor, **kw)
    squeeze = q.ndim == 3
    if squeeze:
        q, q_pos = q[:, None], q_pos[:, None]
        k_new, v_new = k_new[:, None], v_new[:, None]
    if stand_in(q):
        out = _stand_in(paged_attention_fused, q, k_arena, tables, q_pos,
                        k_new, cursor)
    else:
        out = _launch(paged_attention_fused, q, k_new, v_new, k_arena,
                      v_arena, pos_arena, tables, q_pos, cursor, **kw)
    return out[:, 0] if squeeze else out


def paged_attention(q, k_arena, v_arena, pos_arena, tables, q_pos, *,
                    scale, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None):
    """K7: attention (fp32, shaped like q: (B, h, hd) with q_pos (B,), or
    (B, S, h, hd) with q_pos (B, S)) of q against the post-write arenas
    through the block tables; nothing is written. A query row with no
    valid key returns exactly 0. CPU tensors run paged_attention_plain;
    CUDA tensors launch the kernel or raise. `paged_attention.launches`
    counts kernel launches."""
    kw = dict(scale=scale, causal=causal, window=window, softcap=softcap)
    squeeze = q.ndim == 3
    if squeeze:
        q, q_pos = q[:, None], q_pos[:, None]
    if stand_in(q):
        out = _stand_in(paged_attention, q, k_arena, tables, q_pos)
    elif _on_cuda(q):
        out = _launch(paged_attention, q, None, None, k_arena, v_arena,
                      pos_arena, tables, q_pos, None, **kw)
    else:
        out = paged_attention_plain(q, k_arena, v_arena, pos_arena, tables,
                                    q_pos, **kw)
    return out[:, 0] if squeeze else out


paged_attention_fused.launches = 0
paged_attention.launches = 0
