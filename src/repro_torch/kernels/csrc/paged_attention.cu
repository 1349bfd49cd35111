// Paged decode attention for Hopper (sm_90a): K8 with the K/V/pos write
// fused in, and K7, its read side alone, as a split-KV (flash-decoding)
// kernel and a combine kernel.
//
// Replaces the TPU kernels of src/repro/kernels/paged_attention_kernel.py:
//   K8 paged_attention_fused (its fold _online_fold and _finish_out), entry
//      paged_attention_fused_launch, held to
//      repro_torch/kernels/paged_attention.py:paged_attention_fused_plain;
//   K7 paged_attention (_paged_attn_kernel), entry paged_attention_launch,
//      held to paged_attention.py:paged_attention_plain. It is the same
//      two templates with kNew = false: the virtual block of new rows, the
//      stale-row masking and the writes are compiled out. S is then not
//      bound by bs, since no new rows share the block buffer.
//
// What it computes, per slot b: the S query rows attend, through the slot's
// block table, to every key of the arena blocks it names plus (K8) the S new
// rows, with an fp32 online softmax; then (K8) the new K/V rows are written
// into the arena at ring row r = (cursor[b] + s) % (nb * bs), i.e. at
// arena[table[b, r / bs], r % bs], with pos = q_pos[b, s]. Rows with
// q_pos < 0 write nothing and block 0 (the null block) is never written.
// The stored values are copied, never computed, so the arenas match the
// plain version bit for bit. A query row with no valid key returns 0.
//
// What bounds it on an H100: bytes. Each referenced block costs
// 2 * bs * hd * sizeof(arena) bytes of K/V per KV head plus bs * 4 bytes of
// positions, against about 4 * S * (h / n_kv) * hd flops per key and head:
// far below the ~295 flop/byte the card needs before its arithmetic limits.
// At decode a slot's whole context is a few MB per head, so the design is
// about keeping every SM streaming, each about the same number of bytes:
//   * split KV: split k of (slot b, KV head g) takes the table entries k,
//     k + n_split, ... of slot b (strided, so the null entries at the end
//     of a short slot's table spread over all splits) and writes a partial
//     (m, l, acc[hd]) per query row, in fp32, to scratch the wrapper
//     allocates; K8 adds split 0 in front, which folds the S new rows
//     alone. A CTA of the first launch (grid (n_split, n_kv, n_groups))
//     takes one split of every slot of its group z (b = z, z + n_groups,
//     ...), so that CTAs of long, short and dead slots do about the same
//     work. n_split, chunk (entries of a slot per split) and n_groups come
//     from the shapes and the SM count only (paged_attention.py:
//     split_plan), never from the tables;
//   * warp 0 feeds one ring of kStages buffers through all the group's
//     slots: a block's K and V rows of head g (hd contiguous elements each)
//     and its positions, in the arena dtype, by bulk copies (Hopper's TMA,
//     one instruction per row, a lane per row; with the first block of a
//     slot, its q rows), each buffer with an mbarrier that counts the bytes
//     in. Null table entries (positions -1 by the pool's contract) are left
//     out of the ring: a lane holds each of the split's entries of a slot,
//     the next slot's loaded one slot ahead;
//   * the four warps share out each block's keys in tiles of kKeys, and
//     each keeps its own online-softmax state of every query row (where
//     four fp32 states of every row do not fit the shared memory, as at
//     gemma2-2b's heads from S = 12, the warps form two groups of keys and
//     two groups of rows instead, so that a row has two states; the
//     template's kKG, which the wrapper picks: key_groups): lanes
//     over head_dim for the QK dots of a tile of kRows rows x kKeys keys
//     (8 elements a lane, converted in registers), one transposing shuffle
//     sum for the tile, the lanes of each (row, key) pair for the mask,
//     max and sum, lanes over head_dim again for P.V. One barrier per
//     block, before its buffer is refilled; when the slot changes, the
//     warps' states are merged in warp order into the slot's partial;
//   * the combine launch (grid (R, n_kv, B)) starts before the first ends
//     (programmatic dependent launch) and merges each query row's partials
//     in a fixed order, so the output repeats bit for bit: the weights go
//     to shared memory, eight thread groups take every eighth split, eight
//     loads in flight a thread, and add their sums in group order. A split
//     with no valid key has m = -inf and l = 0 and weighs nothing, and a
//     row whose splits are all empty is exactly 0.
// It equals scatter-then-attend (the plain version) whenever block 0 holds
// positions -1, a slot's table names each real block at most once, and no
// block that one slot writes is named in another slot's table: the paged
// pool's contract. The new rows are folded as a virtual block; the stale
// rows they will overwrite are masked while streaming, and a new row whose
// ring row lands on a null table entry (so it is never written) is masked
// in the virtual block, which is exactly what attending after the scatter
// would see.
// A race designed out: the writes of K, V and positions happen in the
// combine launch, after its wait for the whole first grid, so no split can
// see a new row twice (as the virtual block and as a row).
//
// Shape limits of this tiling (checked by the wrapper, ensure_kernel_fit):
// h % n_kv == 0, hd % 8 == 0 and bs % 4 == 0 (16-byte rows of K/V and of
// positions), K8 S <= bs (the new rows share a block buffer), 16-byte
// aligned operands, and the shared-memory plan below must fit the 227 KB a
// block may use with two key groups. The wrapper computes that plan's
// size (paged_attention.py:smem_bytes) and the key groups (key_groups)
// and passes both in.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;       // a split CTA
constexpr int kWarps = kThreads / 32;
constexpr int kCombineThreads = 512;
constexpr int kGroups = 8;          // thread groups of a combine CTA
constexpr int kStages = 2;          // blocks in a split CTA's ring
constexpr int kVec = 8;             // head_dim elements of a lane per step
constexpr int kSpan = 32 * kVec;    // head_dim elements of a warp per step
constexpr int kRows = 2;            // query rows of a fold tile
constexpr int kKeys = 4;            // keys of a fold tile
constexpr int kPairs = kRows * kKeys;   // four lanes per (row, key) pair
// the ring's mbarriers, rounded up to 16 bytes
constexpr int kBarBytes = (kStages * 8 + 15) / 16 * 16;

struct Params {
  const void* q;       // (B, S, h, hd) fp32, bf16 or fp16
  const void* k_new;   // (B, S, n_kv, hd) arena dtype
  const void* v_new;
  void* k_arena;       // (n_blocks, bs, n_kv, hd) fp32 or bf16
  void* v_arena;
  int* pos_arena;      // (n_blocks, bs)
  const int* tables;   // (B, nb)
  const int* q_pos;    // (B, S)
  const int* cursor;   // (B,)
  float* out;          // (B, S, h, hd)
  float* part;         // acc (B, n_kv, n_split, R, hd), then (m, l) of each
  int B, S, h, n_kv, hd, bs, nb;
  int n_split;         // partials of a row: the table's splits (K8: + 1)
  int chunk;           // table entries of a slot per split
  int n_groups;        // slot groups: a split CTA takes slots z + n * this
  int key_groups;      // warps sharing each row's keys: 4 or 2 (kKG)
  float scale;
  int causal;
  int window;          // <= 0: no window
  float softcap;       // <= 0: no cap
};

// kVec consecutive elements (16-byte aligned) of shared memory, as fp32
__device__ __forceinline__ void load8(const float* p, float (&x)[kVec]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&x)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const __half* p, float (&x)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __half2* h2 = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h2[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float (&x)[kVec]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Hopper's bulk copies (the TMA unit): one instruction moves a whole
// 16-byte-aligned row into shared memory and reports its bytes to an
// mbarrier, which a phase-parity wait observes.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar)));
}
// bytes the phase waits for, on top of its one arrival
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// generic-proxy accesses of shared memory before later bulk copies into it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// rows x hd elements of one head into dst (rows * hd, dense), one bulk copy
// per row from the lanes; src points at row 0 and rows are `stride`
// elements apart. Lane 0 has announced the bytes to `bar`.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, int rows,
                                          int hd, size_t stride,
                                          uint64_t* bar, int lane) {
  for (int t = lane; t < rows; t += 32)
    bulk_copy(dst + (size_t)t * hd, src + t * stride,
              static_cast<unsigned>(hd * sizeof(T)), bar);
}

// Each lane holds kPairs partial sums v[0..kPairs-1] of the (row, key)
// pairs of a tile; afterwards v[0] of lane l is the warp's whole sum of
// pair l / (32 / kPairs). Halving steps hand half the values to the partner
// lane (log2 kPairs of them), then plain steps add over the lanes that
// share a pair: 5 + kPairs - 2 shuffles in all, where a reduction per
// pair would take 5 * kPairs.
template <int O, int N>
__device__ __forceinline__ void transpose_sum(float (&v)[kPairs], int lane) {
  if constexpr (N > 1) {
    const bool up = lane & O;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float send = up ? v[i] : v[i + N / 2];
      const float keep = up ? v[i + N / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    transpose_sum<O / 2, N / 2>(v, lane);
  } else if constexpr (O >= 1) {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
    transpose_sum<O / 2, 1>(v, lane);
  }
}

// The shared-memory plan of one split CTA, in this order
// (R = S * h / n_kv):
//   barriers kStages mbarriers, to 16 bytes
//   K ring   kStages * bs * hd    arena dtype
//   V ring   kStages * bs * hd    arena dtype
//   q ring   kStages * R * hd     4 bytes an element, q's dtype (fp32, bf16,
//                                 fp16: the 2-byte ones use half of it)
//   q        R * hd               the same, of the slot being folded
//   acc      kg * R * hd          fp32, unnormalised, per key group and row
//   key pos  kStages * bs         int (bs % 4 == 0: 16-byte aligned rows)
//   meta     kStages * (4 + S)    int: slot, entry, first, cursor, q_pos
//   m, l     2 * kg * R           fp32, running max and sum, per key group
//   q pos    R                    int, of the slot being folded
// paged_attention.py:smem_bytes mirrors it.

// One CTA per (split, KV head, slot group): for each slot b of its group
// (b = z, z + n_groups, ...) the partial softmax state of the R rows over
// the split's table entries of slot b (K8's split 0: over the slot's S new
// rows). Every CTA of a launch so streams about the same number of blocks,
// whichever slots are long, short or dead. One ring runs through all of
// the group's slots; warp 0 feeds it. With kKG key groups, warp w is in
// key group w % kKG and row group w / kKG: it folds the key tiles w % kKG,
// w % kKG + kKG, ... of each block into its key group's (m, l, acc) of the
// rows of its row group (tiles of kRows rows: w / kKG, w / kKG + kWarps /
// kKG,
// ...), kRows query rows x kKeys keys at a time: lanes over head_dim for
// the dot products and P.V, and 32 / kPairs lanes per (row, key) pair for
// the mask and the softmax. When the slot changes, the key groups' states
// are merged in group order into the slot's partial.
template <typename TQ, typename TKV, bool kNew, int kKG>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(Params p) {
  static_assert(kKG == kWarps || kKG == kWarps / 2, "4 or 2 key groups");
  const int k = blockIdx.x;
  const int g = blockIdx.y;
  const int z = blockIdx.z;
  const int G = p.h / p.n_kv;
  const int R = p.S * G;            // query rows of this KV head: r = s*G + i
  const int hd = p.hd;
  const int bs = p.bs;
  const int ring = p.nb * bs;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int kg = kKG;
  const int kgrp = warp % kg;       // this warp's key group
  const int rgrp = warp / kg;       // and row group, of kWarps / kg
  const size_t stride = (size_t)p.n_kv * hd;
  const int meta_len = 4 + p.S;
  // K8's split 0 folds the slots' new rows; table split kt (partial
  // kt + 1 in K8) takes the entries kt, kt + nt, ... of each slot
  const bool virt = kNew && k == 0;
  const int nt = p.n_split - (kNew ? 1 : 0);
  const int kt = k - (kNew ? 1 : 0);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  TKV* sk = reinterpret_cast<TKV*>(smem_raw + kBarBytes);
  TKV* sv = sk + (size_t)kStages * bs * hd;
  float* qring = reinterpret_cast<float*>(sv + (size_t)kStages * bs * hd);
  TQ* sq = reinterpret_cast<TQ*>(qring + (size_t)kStages * R * hd);
  float* sacc = reinterpret_cast<float*>(sq) + R * hd;
  int* skp = reinterpret_cast<int*>(sacc + kg * R * hd);  // 16-aligned
  int* smeta = skp + kStages * bs;
  float* sm = reinterpret_cast<float*>(smeta + kStages * meta_len);
  float* sl = sm + kg * R;
  int* sqpos = reinterpret_cast<int*>(sl + kg * R);
  // this warp's key group's states: row r at [r]
  float* wacc = sacc + kgrp * R * hd;
  float* wm = sm + kgrp * R;
  float* wl = sl + kgrp * R;
  float* ml = p.part + (size_t)p.B * p.n_kv * p.n_split * R * hd;
  // partial (b, g, k) of row r is row base(b) + r
  auto base = [&](int b) {
    return (((size_t)b * p.n_kv + g) * p.n_split + k) * R;
  };

  // ---- warp 0 feeds the ring: the cursor (ib, the lanes' entries of slot
  // ib still to stream) walks the group's slots; the next slot's entries
  // are loaded one slot ahead
  auto entries = [&](int b) {      // this lane's entry of slot b, 0: none
    const int j = kt + lane * nt;
    return (!virt && b < p.B && lane < p.chunk && j < p.nb)
               ? p.tables[(size_t)b * p.nb + j] : 0;
  };
  int ib = z - p.n_groups;
  int imy = 0, inext = 0;
  unsigned imask = 0;
  bool ifirst = false;
  auto next_slot = [&]() {         // to the next slot with a block to fold
    for (;;) {
      ib += p.n_groups;
      if (ib >= p.B) return;
      ifirst = true;
      if (virt) {                  // one item: the slot's new rows
        imask = 1;
        return;
      }
      imy = inext;
      inext = entries(ib + p.n_groups);
      imask = __ballot_sync(0xffffffffu, imy != 0);
      if (imask) return;
      // none of the split's entries of slot ib names a block: its partial
      // is empty (m = -inf, l = 0; the combine never reads its acc)
      for (int r = lane; r < R; r += 32) {
        ml[2 * (base(ib) + r)] = -INFINITY;
        ml[2 * (base(ib) + r) + 1] = 0.f;
      }
    }
  };

  const unsigned row_bytes = static_cast<unsigned>(hd * sizeof(TKV));
  auto issue = [&](int i) {        // ring slot i: the cursor's next item
    const int st = i % kStages;
    uint64_t* bar = bars + st;
    int* meta = smeta + st * meta_len;
    fence_proxy_async();            // the slot's last fold read it
    if (ib >= p.B) {                // nothing left: an end mark
      if (lane == 0) {
        meta[0] = -1;
        mbar_arrive(bar);
      }
      return;
    }
    TKV* dk = sk + (size_t)st * bs * hd;
    TKV* dv = sv + (size_t)st * bs * hd;
    int* dp = skp + st * bs;
    const int b = ib;
    int j = -1, blk = 0;
    if (!virt) {
      const int src = __ffs(imask) - 1;
      imask &= imask - 1;
      j = kt + src * nt;
      blk = __shfl_sync(0xffffffffu, imy, src);
    }
    const bool first = ifirst;
    const unsigned q_bytes =
        first ? static_cast<unsigned>(R * hd * sizeof(TQ)) : 0u;
    if (lane == 0)
      mbar_expect(bar, q_bytes + (virt ? 2 * p.S * row_bytes
                                       : 2 * bs * row_bytes + bs * 4));
    __syncwarp();
    if (virt) {
      const size_t off = ((size_t)b * p.S * p.n_kv + g) * hd;
      copy_rows(dk, static_cast<const TKV*>(p.k_new) + off, p.S, hd, stride,
                bar, lane);
      copy_rows(dv, static_cast<const TKV*>(p.v_new) + off, p.S, hd, stride,
                bar, lane);
    } else {
      const size_t off = ((size_t)blk * bs * p.n_kv + g) * hd;
      copy_rows(dk, static_cast<const TKV*>(p.k_arena) + off, bs, hd, stride,
                bar, lane);
      copy_rows(dv, static_cast<const TKV*>(p.v_arena) + off, bs, hd, stride,
                bar, lane);
      if (lane == 0)
        bulk_copy(dp, p.pos_arena + (size_t)blk * bs, bs * 4, bar);
    }
    if (first) {                    // the slot's q rows ride along
      TQ* dq = reinterpret_cast<TQ*>(qring + (size_t)st * R * hd);
      for (int r = lane; r < R; r += 32) {
        const int s = r / G, i = r - s * G;
        bulk_copy(dq + (size_t)r * hd,
                  static_cast<const TQ*>(p.q) +
                      (((size_t)b * p.S + s) * p.h + g * G + i) * hd,
                  static_cast<unsigned>(hd * sizeof(TQ)), bar);
      }
    }
    // the record, while the copies are in flight
    const int* qp = p.q_pos + (size_t)b * p.S;
    const int* tbl = p.tables + (size_t)b * p.nb;
    // the new rows' table entries: the first 32 one per lane, loaded
    // beside the cursor rather than after it
    const int tb = (virt && lane < p.nb) ? tbl[lane] : 0;
    int cur = 0;
    if (kNew) {
      cur = p.cursor[b] % ring;
      if (cur < 0) cur += ring;
    }
    if (lane == 0) {
      meta[0] = b;
      meta[1] = j;
      meta[2] = first;
      meta[3] = cur;
    }
    for (int s = lane; s < p.S; s += 32) meta[4 + s] = qp[s];
    if (virt) {
      // a new row routed to a null table entry is never written, so the
      // scatter-then-attend version never sees it
      for (int t0 = 0; t0 < p.S; t0 += 32) {
        const int t = t0 + lane;
        int rr = cur + t;
        if (rr >= ring) rr -= ring;
        const int e = t < p.S ? rr / bs : 0;
        const int near = __shfl_sync(0xffffffffu, tb, e & 31);
        if (t < p.S)
          dp[t] = (e < 32 ? near : tbl[e]) != 0 ? qp[t] : -1;
      }
    }
    __syncwarp();                   // the lanes' stores before the arrival
    if (lane == 0) mbar_arrive(bar);
    ifirst = false;
    if (virt) imask = 0;
    if (imask == 0) next_slot();
  };

  int cur = 0;                      // the folded slot's cursor (K8)
  // fold this warp's key tiles of ring slot st (table entry j, `rows` keys)
  auto fold = [&](int st, int j, int rows) {
    const TKV* kb = sk + (size_t)st * bs * hd;
    const TKV* vb = sv + (size_t)st * bs * hd;
    const int* kpb = skp + st * bs;
    const int pair = lane / (32 / kPairs);
    const int lr = pair / kKeys, lt = pair % kKeys;   // this lane's pair
    for (int r0 = rgrp * kRows; r0 < R; r0 += kRows * (kWarps / kg)) {
      for (int t0 = kgrp * kKeys; t0 < rows; t0 += kKeys * kg) {
        float dot[kPairs];
#pragma unroll
        for (int i = 0; i < kPairs; ++i) dot[i] = 0.f;
        for (int c = lane * kVec; c < hd; c += kSpan) {
          float qx[kRows][kVec];   // q's dtype, converted here
#pragma unroll
          for (int rr = 0; rr < kRows; ++rr) {
            if (r0 + rr < R) {
              load8(sq + (r0 + rr) * hd + c, qx[rr]);
            } else {
#pragma unroll
              for (int e = 0; e < kVec; ++e) qx[rr][e] = 0.f;
            }
          }
#pragma unroll
          for (int u = 0; u < kKeys; ++u) {
            if (t0 + u < rows) {
              float kx[kVec];
              load8(kb + (size_t)(t0 + u) * hd + c, kx);
#pragma unroll
              for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
                for (int e = 0; e < kVec; ++e)
                  dot[rr * kKeys + u] =
                      fmaf(qx[rr][e], kx[e], dot[rr * kKeys + u]);
            }
          }
        }
        transpose_sum<16, kPairs>(dot, lane);
        // the lanes of pair (lr, lt): row r0 + lr, key t0 + lt
        const int r = r0 + lr, t = t0 + lt;
        float x = -INFINITY;
        if (r < R && t < rows) {
          x = dot[0] * p.scale;
          if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
          int kp = kpb[t];
          if (kNew && j >= 0) {
            // a row the new tokens overwrite is stale: after the scatter
            // it holds the new row, which the virtual block counted
            int dl = j * bs + t - cur;
            if (dl < 0) dl += ring;
            if (dl < p.S && sqpos[dl * G] >= 0) kp = -1;
          }
          const int qq = sqpos[r];
          bool ok = kp >= 0;
          if (p.causal) ok = ok && kp <= qq;
          if (p.window > 0) ok = ok && (qq - kp) < p.window;
          if (!ok) x = -INFINITY;
        }
        // max and sum over the tile's keys of each row (the lane bits
        // between a pair's and a row's)
        float mb = x;
#pragma unroll
        for (int o = 32 / kPairs; o < 32 / kRows; o <<= 1)
          mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, o));
        const float m_old = r < R ? wm[r] : -INFINITY;
        const float m_new = fmaxf(m_old, mb);
        const float e = (x == -INFINITY) ? 0.f : expf(x - m_new);
        float lsum = e;
#pragma unroll
        for (int o = 32 / kPairs; o < 32 / kRows; o <<= 1)
          lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
        float alpha = 1.f;          // nothing valid so far: acc stays 0
        if (m_new != -INFINITY)
          alpha = (m_old == -INFINITY) ? 0.f : expf(m_old - m_new);
        __syncwarp();               // every lane has read m_old
        if (lane % (32 / kRows) == 0 && r < R) {
          wm[r] = m_new;
          wl[r] = alpha * wl[r] + lsum;
        }
        // P.V: lanes over head_dim again, the probabilities by shuffle
        float al[kRows];
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr)
          al[rr] = __shfl_sync(0xffffffffu, alpha, rr * (32 / kRows));
        float pu[kRows][kKeys];
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
          for (int u = 0; u < kKeys; ++u)
            pu[rr][u] = __shfl_sync(0xffffffffu, e,
                                    (rr * kKeys + u) * (32 / kPairs));
        for (int c = lane * kVec; c < hd; c += kSpan) {
          float a[kRows][kVec];
#pragma unroll
          for (int rr = 0; rr < kRows; ++rr) {
            if (r0 + rr < R) {
              load8(wacc + (r0 + rr) * hd + c, a[rr]);
            } else {
#pragma unroll
              for (int i = 0; i < kVec; ++i) a[rr][i] = 0.f;
            }
#pragma unroll
            for (int i = 0; i < kVec; ++i) a[rr][i] *= al[rr];
          }
#pragma unroll
          for (int u = 0; u < kKeys; ++u) {
            if (t0 + u < rows) {
              float vx[kVec];
              load8(vb + (size_t)(t0 + u) * hd + c, vx);
#pragma unroll
              for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
                for (int i = 0; i < kVec; ++i)
                  a[rr][i] = fmaf(pu[rr][u], vx[i], a[rr][i]);
            }
          }
#pragma unroll
          for (int rr = 0; rr < kRows; ++rr)
            if (r0 + rr < R) store8(wacc + (r0 + rr) * hd + c, a[rr]);
        }
        __syncwarp();               // m, l and acc before the next tile
      }
    }
  };
  // merge the key groups' states of each row in group order into slot b's
  // partial; a state with no valid key (m = -inf) weighs 0
  auto merge = [&](int b) {
    for (int r = warp; r < R; r += kWarps) {
      float M = -INFINITY;
#pragma unroll
      for (int w = 0; w < kg; ++w) M = fmaxf(M, sm[w * R + r]);
      float wt[kg];
      float L = 0.f;
#pragma unroll
      for (int w = 0; w < kg; ++w) {
        const float m = sm[w * R + r];
        wt[w] = (m == -INFINITY) ? 0.f : expf(m - M);
        L += wt[w] * sl[w * R + r];
      }
      for (int c = lane * 4; c < hd; c += 128) {
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int w = 0; w < kg; ++w) {
          const float4 x = *reinterpret_cast<const float4*>(
              sacc + (w * R + r) * hd + c);
          a.x = fmaf(wt[w], x.x, a.x);
          a.y = fmaf(wt[w], x.y, a.y);
          a.z = fmaf(wt[w], x.z, a.z);
          a.w = fmaf(wt[w], x.w, a.w);
        }
        *reinterpret_cast<float4*>(p.part + (base(b) + r) * hd + c) = a;
      }
      if (lane == 0) {
        ml[2 * (base(b) + r)] = M;
        ml[2 * (base(b) + r) + 1] = L;
      }
    }
  };

  if (warp == 0) inext = entries(z);  // in flight across the set-up
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) {
    next_slot();
    for (int i = 0; i < kStages; ++i) issue(i);
  }

  // ring slot i lands on barrier i % kStages, in that barrier's phase
  // (i / kStages) % 2; once every warp has folded it, its buffer takes
  // ring slot i + kStages
  int active = -1;                  // the slot whose states the warps hold
  for (int i = 0;; ++i) {
    const int st = i % kStages;
    mbar_wait(bars + st, (i / kStages) & 1);
    const int* meta = smeta + st * meta_len;
    const int b = meta[0];
    if (b < 0) break;
    const int j = meta[1];
    if (meta[2]) {                  // the first block of slot b
      if (active >= 0) merge(active);
      __syncthreads();              // the states and q are free
      const uint32_t* from =
          reinterpret_cast<const uint32_t*>(qring + (size_t)st * R * hd);
      const int words = static_cast<int>(R * hd * sizeof(TQ) / 4);
      for (int d = threadIdx.x; d < words; d += kThreads)
        reinterpret_cast<uint32_t*>(sq)[d] = from[d];
      for (int r = threadIdx.x; r < R; r += kThreads)
        sqpos[r] = meta[4 + r / G];
      for (int d = threadIdx.x; d < kg * R * hd; d += kThreads) sacc[d] = 0.f;
      for (int r = threadIdx.x; r < kg * R; r += kThreads) {
        sm[r] = -INFINITY;
        sl[r] = 0.f;
      }
      __syncthreads();
      active = b;
      cur = meta[3];
    }
    fold(st, j, j < 0 ? p.S : bs);
    __syncthreads();
    if (warp == 0) issue(i + kStages);
  }
  if (active >= 0) merge(active);
  // the combine launch may start its set-up; it reads the partials only
  // once this grid has finished
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Second launch, one CTA per (query row, KV head, slot), started early
// (programmatic dependent launch): its set-up (K8: where the new rows go,
// and their bytes) overlaps the splits' tail, and it waits for the split
// grid to finish before it writes the arenas or reads a partial. K8's row
// 0 CTAs write the new rows; every CTA merges its row's partials in a
// fixed order.
template <typename TKV, bool kNew>
__global__ void __launch_bounds__(kCombineThreads)
paged_combine_kernel(Params p) {
  const int r = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int G = p.h / p.n_kv;
  const int R = p.S * G;
  const int hd = p.hd;
  const int n = p.n_split;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // partial (b, g, k, r) is row base + k * R
  const size_t base = ((size_t)b * p.n_kv + g) * n * R + r;
  const float* ml = p.part + (size_t)p.B * p.n_kv * n * R * hd;

  extern __shared__ __align__(16) float cs[];
  float* sw = cs;                   // n weights, then L
  float4* sg = reinterpret_cast<float4*>(cs + (n + 4) / 4 * 4);
  int* sdst = reinterpret_cast<int*>(sg + kGroups * (hd / 4));

  // K8's writes, prepared before the splits finish: row s of the slot
  // goes to arena row sdst[s] (-1: nothing), head g; this thread's 16-byte
  // piece (t < S * hd / per) of the new K and V rows is loaded already
  constexpr int per = 16 / sizeof(TKV);
  const int chunks = hd / per;
  uint4 knew = make_uint4(0, 0, 0, 0), vnew = knew;
  if (kNew && r == 0) {
    const int ring = p.nb * p.bs;
    int cur = p.cursor[b] % ring;
    if (cur < 0) cur += ring;
    const int* tbl = p.tables + (size_t)b * p.nb;
    const int* qp = p.q_pos + (size_t)b * p.S;
    for (int s = threadIdx.x; s < p.S; s += kCombineThreads) {
      int rr = cur + s;
      if (rr >= ring) rr -= ring;
      const int e = rr / p.bs;
      const int dst = tbl[e];
      sdst[s] = (qp[s] >= 0 && dst != 0) ? dst * p.bs + rr - e * p.bs : -1;
    }
    const int t = threadIdx.x;
    if (t < p.S * chunks) {
      const int s = t / chunks, c = t - s * chunks;
      const size_t from = (((size_t)b * p.S + s) * p.n_kv + g) * hd;
      knew = reinterpret_cast<const uint4*>(
          static_cast<const TKV*>(p.k_new) + from)[c];
      vnew = reinterpret_cast<const uint4*>(
          static_cast<const TKV*>(p.v_new) + from)[c];
    }
  }
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  // kGroups groups of threads over the splits k = grp, grp + kGroups, ...,
  // kLoads of them in flight a thread, each group over the row's float4
  // columns; the groups' sums are then added in group order. The first
  // loads go out before the weights are known.
  constexpr int kCols = kCombineThreads / kGroups;   // columns of a pass
  constexpr int kLoads = 8;
  const int cols = hd / 4;
  const int grp = threadIdx.x / kCols;
  const size_t step = (size_t)R * hd;                // one split
  float4 x[kLoads];
  auto load = [&](int col, int k0) {
    const float* src = p.part + base * hd + (size_t)col * 4;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int kk = k0 + u * kGroups;
      x[u] = (col < cols && kk < n)
                 ? *reinterpret_cast<const float4*>(src + kk * step)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  load(threadIdx.x % kCols, grp);

  for (int k = threadIdx.x; k < n; k += kCombineThreads)
    sw[k] = ml[2 * (base + (size_t)k * R)];
  __syncthreads();
  if (kNew && r == 0) {
    // the writes, now that every split has read the arenas
    for (int t = threadIdx.x; t < p.S * chunks; t += kCombineThreads) {
      const int s = t / chunks, c = t - s * chunks;
      const int row = sdst[s];
      if (row < 0) continue;
      if (t >= kCombineThreads) {   // beyond the pieces loaded early
        const size_t from = (((size_t)b * p.S + s) * p.n_kv + g) * hd;
        knew = reinterpret_cast<const uint4*>(
            static_cast<const TKV*>(p.k_new) + from)[c];
        vnew = reinterpret_cast<const uint4*>(
            static_cast<const TKV*>(p.v_new) + from)[c];
      }
      const size_t to = ((size_t)row * p.n_kv + g) * hd;
      reinterpret_cast<uint4*>(static_cast<TKV*>(p.k_arena) + to)[c] = knew;
      reinterpret_cast<uint4*>(static_cast<TKV*>(p.v_arena) + to)[c] = vnew;
      // the positions are shared by the heads: head 0 writes them
      if (g == 0 && c == 0)
        p.pos_arena[row] = p.q_pos[(size_t)b * p.S + s];
    }
  }
  if (warp == 0) {
    // max and weighted sum over the splits; a split with no valid key
    // (m = -inf) weighs 0. The shuffle tree is fixed, so L repeats.
    float M = -INFINITY;
    for (int k = lane; k < n; k += 32) M = fmaxf(M, sw[k]);
    M = warp_max(M);
    float L = 0.f;
    for (int k = lane; k < n; k += 32) {
      const float m = sw[k];
      const float w = (m == -INFINITY) ? 0.f : expf(m - M);
      sw[k] = w;
      L += w * ml[2 * (base + (size_t)k * R) + 1];
    }
    L = warp_sum(L);
    if (lane == 0) sw[n] = L;
  }
  __syncthreads();
  const float L = sw[n];
  for (int c0 = 0; c0 < cols; c0 += kCols) {
    const int col = c0 + threadIdx.x % kCols;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k0 = grp; k0 < n; k0 += kLoads * kGroups) {
      if (c0 > 0 || k0 > grp) load(col, k0);   // the first are in
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int kk = k0 + u * kGroups;
        if (kk >= n) break;
        const float w = sw[kk];
        if (w == 0.f) continue;     // an empty split: its acc is not set
        a.x = fmaf(w, x[u].x, a.x);
        a.y = fmaf(w, x[u].y, a.y);
        a.z = fmaf(w, x[u].z, a.z);
        a.w = fmaf(w, x[u].w, a.w);
      }
    }
    if (col < cols) sg[grp * cols + col] = a;
    __syncthreads();
    if (grp == 0 && col < cols) {
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);   // no valid key: 0
      if (L > 0.f) {
#pragma unroll
        for (int q = 0; q < kGroups; ++q) {
          const float4 y = sg[q * cols + col];
          o.x += y.x; o.y += y.y; o.z += y.z; o.w += y.w;
        }
        o.x /= L; o.y /= L; o.z /= L; o.w /= L;
      }
      const int s = r / G, i = r - s * G;
      reinterpret_cast<float4*>(
          p.out + (((size_t)b * p.S + s) * p.h + g * G + i) * hd)[col] = o;
    }
    __syncthreads();
  }
}

// the combine CTA's shared memory: the weights (padded to 16 bytes), the
// groups' column sums, K8's write destinations
size_t combine_smem(const Params& p) {
  return ((p.n_split + 4) / 4 * 4) * sizeof(float) +
         (size_t)kGroups * (p.hd / 4) * sizeof(float4) + p.S * sizeof(int);
}

template <typename TQ, typename TKV, bool kNew, int kKG>
cudaError_t launch_split(const Params& p, size_t smem, cudaStream_t stream) {
  // opt in to the largest dynamic shared memory asked for so far, once per
  // instantiation
  static size_t opted_in = 0;
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_split_kernel<TQ, TKV, kNew, kKG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  paged_split_kernel<TQ, TKV, kNew, kKG>
      <<<dim3(p.n_split, p.n_kv, p.n_groups), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, bool kNew>
cudaError_t launch_attention(const Params& p, size_t smem,
                             cudaStream_t stream) {
  if (p.key_groups != kWarps && p.key_groups != kWarps / 2)
    return cudaErrorInvalidValue;
  const cudaError_t err =
      p.key_groups == kWarps
          ? launch_split<TQ, TKV, kNew, kWarps>(p, smem, stream)
          : launch_split<TQ, TKV, kNew, kWarps / 2>(p, smem, stream);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.S * (p.h / p.n_kv), p.n_kv, p.B);
  cfg.blockDim = dim3(kCombineThreads);
  cfg.dynamicSmemBytes = combine_smem(p);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, paged_combine_kernel<TKV, kNew>, p);
}

// q's dtype code, as paged_attention.py's Q_CODES gives it
enum QType : int { kQF32 = 0, kQBF16 = 1, kQF16 = 2 };

template <typename TQ, bool kNew>
cudaError_t launch_for_q(const Params& p, int kv_bf16, size_t smem,
                         cudaStream_t st) {
  return kv_bf16 ? launch_attention<TQ, __nv_bfloat16, kNew>(p, smem, st)
                 : launch_attention<TQ, float, kNew>(p, smem, st);
}

template <bool kNew>
cudaError_t launch_attention(const Params& p, int q_type, int kv_bf16,
                             size_t smem, cudaStream_t st) {
  switch (q_type) {
    case kQF32:
      return launch_for_q<float, kNew>(p, kv_bf16, smem, st);
    case kQBF16:
      return launch_for_q<__nv_bfloat16, kNew>(p, kv_bf16, smem, st);
    case kQF16:
      return launch_for_q<__half, kNew>(p, kv_bf16, smem, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// part: fp32 scratch of B * n_kv * n_split * R * (hd + 2) floats, n_split
// counting K8's split of new rows; key_groups: 4 or 2, the warps that
// share each row's keys; smem: the dynamic shared memory of one split CTA,
// in bytes (paged_attention.py:smem_bytes at that key_groups). Returns a
// cudaError_t; 0 when both launches were accepted.
extern "C" int paged_attention_fused_launch(
    const void* q, int q_type, const void* k_new, const void* v_new,
    void* k_arena, void* v_arena, int kv_bf16, int* pos_arena,
    const int* tables, const int* q_pos, const int* cursor, float* out,
    float* part, int B, int S, int h, int n_kv, int hd, int bs, int nb,
    int n_split, int chunk, int n_groups, int key_groups, float scale,
    int causal, int window, float softcap, size_t smem, void* stream) {
  Params p{q, k_new, v_new, k_arena, v_arena, pos_arena, tables, q_pos,
           cursor, out, part, B, S, h, n_kv, hd, bs, nb, n_split, chunk,
           n_groups, key_groups, scale, causal, window, softcap};
  return static_cast<int>(launch_attention<true>(
      p, q_type, kv_bf16, smem, static_cast<cudaStream_t>(stream)));
}

// K7: the attention of q against the arenas the tables name; nothing is
// written. part and smem as above.
extern "C" int paged_attention_launch(
    const void* q, int q_type, const void* k_arena, const void* v_arena,
    int kv_bf16, const int* pos_arena, const int* tables, const int* q_pos,
    float* out, float* part, int B, int S, int h, int n_kv, int hd, int bs,
    int nb, int n_split, int chunk, int n_groups, int key_groups,
    float scale, int causal, int window, float softcap, size_t smem,
    void* stream) {
  Params p{q, nullptr, nullptr, const_cast<void*>(k_arena),
           const_cast<void*>(v_arena), const_cast<int*>(pos_arena), tables,
           q_pos, nullptr, out, part, B, S, h, n_kv, hd, bs, nb, n_split,
           chunk, n_groups, key_groups, scale, causal, window, softcap};
  return static_cast<int>(launch_attention<false>(
      p, q_type, kv_bf16, smem, static_cast<cudaStream_t>(stream)));
}
