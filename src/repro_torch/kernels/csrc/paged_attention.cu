// Paged decode attention for Hopper (sm_90a): K8 with the K/V/pos write
// fused in, and K7, its read side alone.
//
// Replaces the TPU kernels of src/repro/kernels/paged_attention_kernel.py:
//   K8 paged_attention_fused (its fold _online_fold and _finish_out), entry
//      paged_attention_fused_launch, held to
//      repro_torch/kernels/paged_attention.py:paged_attention_fused_plain;
//   K7 paged_attention (_paged_attn_kernel), entry paged_attention_launch,
//      held to paged_attention.py:paged_attention_plain. It is the same
//      kernel template with kNew = false: the virtual block of new rows
//      (j = -1), the stale-row masking and both writes are compiled out,
//      and the sweep attends to exactly the blocks the table names (the
//      null block, whose positions are -1 by the pool's contract, is
//      skipped as in K8). S is then not bound by bs, since no new rows
//      share the block buffer.
//
// The rest of this note describes K8; K7 is its first half.
//
// What it computes, per slot b: the S query rows attend, through the slot's
// block table, to every key of the arena blocks it names plus the S new rows,
// with an fp32 online softmax; then the new K/V rows are written into the
// arena at ring row r = (cursor[b] + s) % (nb * bs), i.e. at
// arena[table[b, r / bs], r % bs], with pos = q_pos[b, s]. Rows with
// q_pos < 0 write nothing and block 0 (the null block) is never written.
// The stored values are copied, never computed, so the arenas match the
// plain version bit for bit.
//
// What bounds it on an H100: bytes. Each streamed block costs
// 2 * bs * hd * sizeof(arena) bytes of K/V per KV head plus bs * 4 bytes of
// positions, against about 4 * S * (h / n_kv) * hd flops per key and head:
// far below the ~295 flop/byte the card needs before its arithmetic limits.
// So the design moves each referenced block once and nothing else:
//   * one CTA per (slot, KV head) streams exactly the blocks of the slot's
//     table, for its head only, into shared memory (no dense copy of the
//     ring exists, unlike the gather of the plain version);
//   * unbacked table entries point at the null block, whose positions are
//     -1 by the pool's contract; they are skipped instead of streamed;
//   * the S * (h / n_kv) query rows of one KV head (GQA without repeating
//     K/V) share each block load; their state (m, l, acc) stays in shared
//     memory in fp32 for the whole sweep;
//   * the S new rows fold once as a virtual block before the first real
//     block; the stale rows they will overwrite are masked while streaming,
//     and a new row whose ring row lands on a null table entry (so it is
//     never written) is masked in the virtual block, which is exactly what
//     attending after the scatter would see.
// It equals scatter-then-attend (the plain version) whenever block 0 holds
// positions -1, a slot's table names each real block at most once, and no
// block that one slot writes is named in another slot's table: the paged
// pool's contract. Outside it (a real block named twice, a block written
// by one slot and read by another in the same launch) the two may differ.
// A race designed out: K/V of head g of a slot are read and written by CTA
// (b, g) alone, after its own reads. The positions are shared by all heads
// of a slot, so a CTA that wrote pos while a sibling head's CTA still
// streamed that block would make the new row visible twice (as the virtual
// block and as a real row). The positions are therefore written by a second
// launch on the same stream, after every read of the first has finished.
//
// Shape limits of this tiling (checked by the wrapper, ensure_kernel_fit):
// h % n_kv == 0, S <= bs, and the shared-memory plan below must fit the
// 227 KB a block may use. The wrapper computes that plan's size
// (paged_attention.py:smem_bytes) and passes it in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Params {
  const void* q;       // (B, S, h, hd) fp32 or bf16
  const void* k_new;   // (B, S, n_kv, hd) arena dtype
  const void* v_new;
  void* k_arena;       // (n_blocks, bs, n_kv, hd) fp32 or bf16
  void* v_arena;
  int* pos_arena;      // (n_blocks, bs)
  const int* tables;   // (B, nb)
  const int* q_pos;    // (B, S)
  const int* cursor;   // (B,)
  float* out;          // (B, S, h, hd)
  int B, S, h, n_kv, hd, bs, nb;
  float scale;
  int causal;
  int window;          // <= 0: no window
  float softcap;       // <= 0: no cap
};

// kNew: fold the S new rows as a virtual block and write them (K8); without
// it the kernel reads the arenas only (K7).
template <typename TQ, typename TKV, bool kNew>
__global__ void __launch_bounds__(kThreads)
paged_attention_fused_kernel(Params p) {
  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int G = p.h / p.n_kv;
  const int R = p.S * G;            // query rows of this KV head: r = s*G + i
  const int hd = p.hd;
  const int bs = p.bs;
  const int ring = p.nb * bs;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cur = kNew ? p.cursor[b] : 0;
  const int* qp = p.q_pos + (size_t)b * p.S;

  extern __shared__ float smem[];
  float* sq = smem;                 // R * hd   queries (fp32)
  float* sacc = sq + R * hd;        // R * hd   unnormalised output
  float* sk = sacc + R * hd;        // bs * hd  keys of the current block
  float* sv = sk + bs * hd;         // bs * hd  values of the current block
  float* sp = sv + bs * hd;         // R * bs   logits, then probabilities
  float* sm = sp + R * bs;          // R        running max
  float* sl = sm + R;               // R        running sum
  float* sa = sl + R;               // R        rescale of this block
  int* skp = reinterpret_cast<int*>(sa + R);  // bs key positions

  for (int idx = tid; idx < R * hd; idx += kThreads) {
    const int r = idx / hd, d = idx - (idx / hd) * hd;
    const int s = r / G, i = r - (r / G) * G;
    sq[idx] = to_f32(static_cast<const TQ*>(p.q)[
        (((size_t)b * p.S + s) * p.h + g * G + i) * hd + d]);
    sacc[idx] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    sm[r] = -INFINITY;
    sl[r] = 0.f;
  }

  // j == -1 is the virtual block of the S new rows; j >= 0 the table.
  for (int j = kNew ? -1 : 0; j < p.nb; ++j) {
    int rows;
    if (kNew && j < 0) {
      rows = p.S;
      for (int idx = tid; idx < rows * hd; idx += kThreads) {
        const int t = idx / hd, d = idx - (idx / hd) * hd;
        const size_t off = (((size_t)b * p.S + t) * p.n_kv + g) * hd + d;
        sk[idx] = to_f32(static_cast<const TKV*>(p.k_new)[off]);
        sv[idx] = to_f32(static_cast<const TKV*>(p.v_new)[off]);
      }
      // a new row routed to a null table entry is never written, so the
      // scatter-then-attend version never sees it
      for (int t = tid; t < rows; t += kThreads) {
        const int rr = (cur + t) % ring;
        skp[t] = p.tables[(size_t)b * p.nb + rr / bs] != 0 ? qp[t] : -1;
      }
    } else {
      const int blk = p.tables[(size_t)b * p.nb + j];
      if (blk == 0) continue;       // null block: every position is -1
      rows = bs;
      for (int idx = tid; idx < rows * hd; idx += kThreads) {
        const int t = idx / hd, d = idx - (idx / hd) * hd;
        const size_t off = (((size_t)blk * bs + t) * p.n_kv + g) * hd + d;
        sk[idx] = to_f32(static_cast<const TKV*>(p.k_arena)[off]);
        sv[idx] = to_f32(static_cast<const TKV*>(p.v_arena)[off]);
      }
      for (int t = tid; t < rows; t += kThreads) {
        int kp = p.pos_arena[(size_t)blk * bs + t];
        const int rr = j * bs + t;
        // a row the new tokens overwrite is stale: after the scatter it
        // holds the new row, which the virtual block already counted
        if (kNew)
          for (int s = 0; s < p.S; ++s)
            if (qp[s] >= 0 && (cur + s) % ring == rr) kp = -1;
        skp[t] = kp;
      }
    }
    __syncthreads();

    // logits: one warp per (query row, key row) pair
    for (int pair = warp; pair < R * rows; pair += kWarps) {
      const int r = pair / rows, t = pair - (pair / rows) * rows;
      float dot = 0.f;
      for (int d = lane; d < hd; d += 32) dot += sq[r * hd + d] * sk[t * hd + d];
      for (int o = 16; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane == 0) {
        float x = dot * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        const int kp = skp[t];
        const int qq = qp[r / G];
        bool ok = kp >= 0;
        if (p.causal) ok = ok && kp <= qq;
        if (p.window > 0) ok = ok && (qq - kp) < p.window;
        sp[r * bs + t] = ok ? x : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax state, one thread per query row
    for (int r = tid; r < R; r += kThreads) {
      float mb = -INFINITY;
      for (int t = 0; t < rows; ++t) mb = fmaxf(mb, sp[r * bs + t]);
      const float m_old = sm[r];
      const float m_new = fmaxf(m_old, mb);
      float alpha = 1.f, lsum = 0.f;
      if (m_new == -INFINITY) {     // nothing valid so far
        for (int t = 0; t < rows; ++t) sp[r * bs + t] = 0.f;
      } else {
        alpha = (m_old == -INFINITY) ? 0.f : expf(m_old - m_new);
        for (int t = 0; t < rows; ++t) {
          const float x = sp[r * bs + t];
          const float e = (x == -INFINITY) ? 0.f : expf(x - m_new);
          sp[r * bs + t] = e;
          lsum += e;
        }
      }
      sm[r] = m_new;
      sl[r] = alpha * sl[r] + lsum;
      sa[r] = alpha;
    }
    __syncthreads();

    for (int idx = tid; idx < R * hd; idx += kThreads) {
      const int r = idx / hd, d = idx - (idx / hd) * hd;
      float a = sa[r] * sacc[idx];
      for (int t = 0; t < rows; ++t) a += sp[r * bs + t] * sv[t * hd + d];
      sacc[idx] = a;
    }
    __syncthreads();
  }

  // a row with no valid key has l == 0 and returns exactly 0
  for (int idx = tid; idx < R * hd; idx += kThreads) {
    const int r = idx / hd, d = idx - (idx / hd) * hd;
    const int s = r / G, i = r - (r / G) * G;
    const float l = sl[r];
    p.out[(((size_t)b * p.S + s) * p.h + g * G + i) * hd + d] =
        l > 0.f ? sacc[idx] / l : 0.f;
  }

  // the write of head g (K8 only): every read of this CTA is behind the last
  // barrier
  if constexpr (kNew) {
    for (int s = 0; s < p.S; ++s) {
      if (qp[s] < 0) continue;
      const int rr = (cur + s) % ring;
      const int dst = p.tables[(size_t)b * p.nb + rr / bs];
      if (dst == 0) continue;
      const size_t src = (((size_t)b * p.S + s) * p.n_kv + g) * hd;
      const size_t to = (((size_t)dst * bs + rr % bs) * p.n_kv + g) * hd;
      for (int d = tid; d < hd; d += kThreads) {
        static_cast<TKV*>(p.k_arena)[to + d] =
            static_cast<const TKV*>(p.k_new)[src + d];
        static_cast<TKV*>(p.v_arena)[to + d] =
            static_cast<const TKV*>(p.v_new)[src + d];
      }
    }
  }
}

// Second launch: the positions of the new rows, after every read above.
__global__ void paged_write_pos_kernel(Params p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.B * p.S) return;
  const int b = i / p.S, s = i - (i / p.S) * p.S;
  const int qq = p.q_pos[i];
  if (qq < 0) return;
  const int rr = (p.cursor[b] + s) % (p.nb * p.bs);
  const int dst = p.tables[(size_t)b * p.nb + rr / p.bs];
  if (dst == 0) return;
  p.pos_arena[(size_t)dst * p.bs + rr % p.bs] = qq;
}

template <typename TQ, typename TKV, bool kNew>
cudaError_t launch_attention(const Params& p, size_t smem,
                             cudaStream_t stream) {
  // opt in to the largest dynamic shared memory asked for so far, once per
  // instantiation
  static size_t opted_in = 0;
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_fused_kernel<TQ, TKV, kNew>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  paged_attention_fused_kernel<TQ, TKV, kNew>
      <<<dim3(p.B, p.n_kv), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kNew>
cudaError_t launch_attention(const Params& p, int q_bf16, int kv_bf16,
                             size_t smem, cudaStream_t st) {
  if (q_bf16)
    return kv_bf16
               ? launch_attention<__nv_bfloat16, __nv_bfloat16, kNew>(p, smem,
                                                                      st)
               : launch_attention<__nv_bfloat16, float, kNew>(p, smem, st);
  return kv_bf16 ? launch_attention<float, __nv_bfloat16, kNew>(p, smem, st)
                 : launch_attention<float, float, kNew>(p, smem, st);
}

}  // namespace

// smem is the dynamic shared memory of one CTA, in bytes. Returns a
// cudaError_t; 0 when both launches were accepted.
extern "C" int paged_attention_fused_launch(
    const void* q, int q_bf16, const void* k_new, const void* v_new,
    void* k_arena, void* v_arena, int kv_bf16, int* pos_arena,
    const int* tables, const int* q_pos, const int* cursor, float* out,
    int B, int S, int h, int n_kv, int hd, int bs, int nb, float scale,
    int causal, int window, float softcap, size_t smem, void* stream) {
  Params p{q, k_new, v_new, k_arena, v_arena, pos_arena, tables, q_pos,
           cursor, out, B, S, h, n_kv, hd, bs, nb, scale, causal, window,
           softcap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch_attention<true>(p, q_bf16, kv_bf16, smem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = B * S;
  paged_write_pos_kernel<<<(n + 127) / 128, 128, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// K7: the attention of q against the arenas the tables name; nothing is
// written. smem as above (the same plan; S rows share no block buffer).
extern "C" int paged_attention_launch(
    const void* q, int q_bf16, const void* k_arena, const void* v_arena,
    int kv_bf16, const int* pos_arena, const int* tables, const int* q_pos,
    float* out, int B, int S, int h, int n_kv, int hd, int bs, int nb,
    float scale, int causal, int window, float softcap, size_t smem,
    void* stream) {
  Params p{q, nullptr, nullptr, const_cast<void*>(k_arena),
           const_cast<void*>(v_arena), const_cast<int*>(pos_arena), tables,
           q_pos, nullptr, out, B, S, h, n_kv, hd, bs, nb, scale, causal,
           window, softcap};
  return static_cast<int>(launch_attention<false>(
      p, q_bf16, kv_bf16, smem, static_cast<cudaStream_t>(stream)));
}
