// The fused LANS optimizer step for Hopper (sm_90a): four kernels K1-K4.
//
// Replaces the TPU kernels of src/repro/kernels/lans_kernel.py:
//   K1 sq_norm            (_sq_norm_kernel)           sum of squares of g
//   K2 lans_phase1        (_lans_phase1_kernel)       g~ = g / ||g||, new
//                         m and v, partial ||r+lam x||^2, ||c+lam x||^2,
//                         ||x||^2
//   K3 lans_phase2        (_lans_phase2_kernel)       trust ratios, the
//                         convex-combination direction d, x <- x - eta d
//   K4 lans_phase2_cast   (_lans_phase2_cast_kernel)  K3 on an fp32 master,
//                         also writing its bf16 / fp16 copy in the same pass
//                         (an fp32 copy is the master itself; the wrapper
//                         then runs the pass with lp_dtype 0)
// The plain PyTorch versions they are held to are in
// repro_torch/kernels/lans.py (*_plain).
//
// What bounds them on an H100: bytes. Every element costs a handful of
// flops against 4-24 bytes of traffic, far below the ~20 flop/byte an fp32
// pass needs before arithmetic limits it. So each kernel reads each operand
// once and writes each output once, with fp32 arithmetic in registers
// whatever the storage dtype:
//   * tensors are flat and of any length; loops are grid-stride with 64-bit
//     offsets (the largest BERT-large leaf has 100,663,296 elements) and the
//     tail is bound-checked, so nothing is padded (the TPU kernels padded to
//     (256, 128) tiles only because the TPU tiles that way);
//   * reductions are deterministic: each CTA reduces its share in a fixed
//     order (registers, then warp shuffles, then one warp over the warps'
//     sums) into a per-CTA partial, and a second one-CTA launch adds the
//     partials in a fixed order. No float atomics, so two runs on the same
//     inputs are bitwise equal. The number of CTAs depends on n only. That
//     machinery, shared with lamb.cu, is in optim_common.cuh;
//   * the per-step scalars ride in an 8-float device array, as the TPU
//     kernels' (1, 8) operand: [bc1, bc2, eta, lam, trust, g_sq, 0, 0]. K1
//     writes g_sq into it; K2's second launch writes the three norms into
//     an 8-float array K3/K4 read. Nothing goes back to the host;
//   * ||g||^2 == 0 or NaN selects g~ = 0 (select, not multiply: g * 0 would
//     keep a NaN), and a trust ratio whose norm is 0, or with the trust flag
//     off, selects 1, as lans_kernel.py:_guarded_scale / _phase2_x_new do;
//   * K3 and K4 are one template: the master K4 writes is computed by the
//     very code that computes K3's output, so the two are equal, and the lp
//     copy is the round-to-nearest-even cast of that value.
// beta1, 1 - beta1, beta2, 1 - beta2 and eps come in as fp32 values rounded
// on the host from the double-precision constants, as the TPU kernels' Python
// float constants are.
#include "optim_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// K1: sum of squares -> per-CTA partials
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
sq_norm_kernel(const T* __restrict__ x, int64_t n, float* __restrict__ parts) {
  __shared__ float smem[kThreads / 32];
  float acc = 0.0f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const float v = ld(x, i);
    acc += v * v;
  }
  acc = block_sum(acc, smem);
  if (threadIdx.x == 0) parts[blockIdx.x] = acc;
}

// ---------------------------------------------------------------------------
// K2: moments and partial norms
// ---------------------------------------------------------------------------
// g~ = g / ||g||, selecting 0 where ||g||^2 is 0 or NaN
__device__ __forceinline__ float g_tilde(float g, float g_sq, float inv) {
  return g_sq > 0.0f ? g * inv : 0.0f;
}

template <typename TG, typename TX>
__global__ void __launch_bounds__(kThreads)
lans_phase1_kernel(const float* __restrict__ scal, const TG* __restrict__ g,
                   const float* __restrict__ m, const float* __restrict__ v,
                   const TX* __restrict__ x, float* __restrict__ m_out,
                   float* __restrict__ v_out, int64_t n, Consts k,
                   float* __restrict__ parts) {
  __shared__ float smem[kThreads / 32];
  const float bc1 = scal[0], bc2 = scal[1], lam = scal[3], g_sq = scal[5];
  const float inv = rsqrtf(fmaxf(g_sq, 1e-38f));
  float r_acc = 0.0f, c_acc = 0.0f, x_acc = 0.0f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const float gt = g_tilde(ld(g, i), g_sq, inv);
    const float xi = ld(x, i);
    const float mn = k.beta1 * m[i] + k.one_minus_beta1 * gt;
    const float vn = k.beta2 * v[i] + k.one_minus_beta2 * (gt * gt);
    m_out[i] = mn;
    v_out[i] = vn;
    const float denom = sqrtf(vn / bc2) + k.eps;
    const float r = (mn / bc1) / denom + lam * xi;
    const float c = gt / denom + lam * xi;
    r_acc += r * r;
    c_acc += c * c;
    x_acc += xi * xi;
  }
  r_acc = block_sum(r_acc, smem);
  c_acc = block_sum(c_acc, smem);
  x_acc = block_sum(x_acc, smem);
  if (threadIdx.x == 0) {
    parts[blockIdx.x] = r_acc;
    parts[gridDim.x + blockIdx.x] = c_acc;
    parts[2 * gridDim.x + blockIdx.x] = x_acc;
  }
}

// ---------------------------------------------------------------------------
// K3 / K4: apply the update (K4 also writes the low-precision copy)
// ---------------------------------------------------------------------------
template <typename TG, typename TX, typename TLP, bool kCast>
__global__ void __launch_bounds__(kThreads)
lans_phase2_kernel(const float* __restrict__ scal,
                   const float* __restrict__ norms, const TG* __restrict__ g,
                   const float* __restrict__ m, const float* __restrict__ v,
                   const TX* __restrict__ x, TX* __restrict__ x_out,
                   TLP* __restrict__ lp_out, int64_t n, Consts k) {
  const float bc1 = scal[0], bc2 = scal[1], eta = scal[2], lam = scal[3];
  const float trust = scal[4], g_sq = scal[5];
  const float inv = rsqrtf(fmaxf(g_sq, 1e-38f));
  const float x_norm = sqrtf(norms[2]);
  // beta1 * sr and (1 - beta1) * sc, grouped as the TPU kernel groups them
  const float a = k.beta1 * trust_ratio(x_norm, norms[0], trust);
  const float b = k.one_minus_beta1 * trust_ratio(x_norm, norms[1], trust);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const float gt = g_tilde(ld(g, i), g_sq, inv);
    const float xi = ld(x, i);
    const float denom = sqrtf(v[i] / bc2) + k.eps;
    const float r = (m[i] / bc1) / denom + lam * xi;
    const float c = gt / denom + lam * xi;
    const float xn = xi - eta * (a * r + b * c);
    st(x_out, i, xn);
    if (kCast) st(lp_out, i, xn);
  }
}

template <typename TG, typename TX>
cudaError_t launch_phase1(const float* scal, const void* g, const float* m,
                          const float* v, const void* x, float* m_out,
                          float* v_out, int64_t n, Consts k, float* parts,
                          float* norms, cudaStream_t st) {
  const int ctas = reduce_ctas(n);
  lans_phase1_kernel<TG, TX><<<ctas, kThreads, 0, st>>>(
      scal, static_cast<const TG*>(g), m, v, static_cast<const TX*>(x), m_out,
      v_out, n, k, parts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  finish_sums_kernel<<<1, kThreads, 0, st>>>(parts, ctas, 3, norms, 8);
  return cudaGetLastError();
}

template <typename TG, typename TX, typename TLP, bool kCast>
cudaError_t launch_phase2(const float* scal, const float* norms,
                          const void* g, const float* m, const float* v,
                          const void* x, void* x_out, void* lp_out, int64_t n,
                          Consts k, cudaStream_t st) {
  lans_phase2_kernel<TG, TX, TLP, kCast>
      <<<elementwise_ctas(n), kThreads, 0, st>>>(
          scal, norms, static_cast<const TG*>(g), m, v,
          static_cast<const TX*>(x), static_cast<TX*>(x_out),
          static_cast<TLP*>(lp_out), n, k);
  return cudaGetLastError();
}

}  // namespace

// Every launcher returns a cudaError_t (0 when its launches were accepted).
// dtype codes: 0 fp32, 1 bf16, 2 fp16. `parts` is scratch of at least
// lans_max_parts() floats (x 3 for phase 1).

extern "C" int lans_max_parts() { return kMaxCtas; }

// K1: out[0] = sum(x^2) in fp32.
extern "C" int lans_sq_norm_launch(const void* x, int x_dtype, int64_t n,
                                   float* parts, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ctas = reduce_ctas(n);
  if (x_dtype == 1)
    sq_norm_kernel<__nv_bfloat16><<<ctas, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), n, parts);
  else
    sq_norm_kernel<float><<<ctas, kThreads, 0, st>>>(
        static_cast<const float*>(x), n, parts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finish_sums_kernel<<<1, kThreads, 0, st>>>(parts, ctas, 1, out, 1);
  return static_cast<int>(cudaGetLastError());
}

// K2: m_out, v_out and norms[0..7] = [r_sq, c_sq, x_sq, 0, 0, 0, 0, 0].
extern "C" int lans_phase1_launch(const float* scal, const void* g,
                                  int g_dtype, const float* m, const float* v,
                                  const void* x, int x_dtype, float* m_out,
                                  float* v_out, int64_t n, float beta1,
                                  float one_minus_beta1, float beta2,
                                  float one_minus_beta2, float eps,
                                  float* parts, float* norms, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Consts k{beta1, one_minus_beta1, beta2, one_minus_beta2, eps};
  cudaError_t err;
  if (g_dtype == 1) {
    err = x_dtype == 1
              ? launch_phase1<__nv_bfloat16, __nv_bfloat16>(
                    scal, g, m, v, x, m_out, v_out, n, k, parts, norms, st)
              : launch_phase1<__nv_bfloat16, float>(
                    scal, g, m, v, x, m_out, v_out, n, k, parts, norms, st);
  } else {
    err = x_dtype == 1
              ? launch_phase1<float, __nv_bfloat16>(
                    scal, g, m, v, x, m_out, v_out, n, k, parts, norms, st)
              : launch_phase1<float, float>(scal, g, m, v, x, m_out, v_out, n,
                                            k, parts, norms, st);
  }
  return static_cast<int>(err);
}

// K3 (lp_dtype 0): x_out = x - eta * d in x's dtype.
// K4 (lp_dtype 1 or 2, x fp32): the same x_out, and lp_out = its cast.
extern "C" int lans_phase2_launch(const float* scal, const float* norms,
                                  const void* g, int g_dtype, const float* m,
                                  const float* v, const void* x, int x_dtype,
                                  void* x_out, void* lp_out, int lp_dtype,
                                  int64_t n, float beta1,
                                  float one_minus_beta1, float eps,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Consts k{beta1, one_minus_beta1, 0.0f, 0.0f, eps};
  cudaError_t err;
  if (lp_dtype == 0) {
    if (g_dtype == 1)
      err = x_dtype == 1
                ? launch_phase2<__nv_bfloat16, __nv_bfloat16, float, false>(
                      scal, norms, g, m, v, x, x_out, nullptr, n, k, st)
                : launch_phase2<__nv_bfloat16, float, float, false>(
                      scal, norms, g, m, v, x, x_out, nullptr, n, k, st);
    else
      err = x_dtype == 1
                ? launch_phase2<float, __nv_bfloat16, float, false>(
                      scal, norms, g, m, v, x, x_out, nullptr, n, k, st)
                : launch_phase2<float, float, float, false>(
                      scal, norms, g, m, v, x, x_out, nullptr, n, k, st);
  } else {
    if (x_dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
    if (g_dtype == 1)
      err = lp_dtype == 1
                ? launch_phase2<__nv_bfloat16, float, __nv_bfloat16, true>(
                      scal, norms, g, m, v, x, x_out, lp_out, n, k, st)
                : launch_phase2<__nv_bfloat16, float, __half, true>(
                      scal, norms, g, m, v, x, x_out, lp_out, n, k, st);
    else
      err = lp_dtype == 1
                ? launch_phase2<float, float, __nv_bfloat16, true>(
                      scal, norms, g, m, v, x, x_out, lp_out, n, k, st)
                : launch_phase2<float, float, __half, true>(
                      scal, norms, g, m, v, x, x_out, lp_out, n, k, st);
  }
  return static_cast<int>(err);
}
