// Shared by the fused optimizer kernels (lans.cu: K1-K4, lamb.cu: K5-K6):
// launch sizes, fp32 loads and rounding stores, the fixed-order CTA sum and
// its one-CTA finishing pass, the optimizer constants and the guarded trust
// ratio. Each .cu file is its own library, so every definition here sits in
// an anonymous namespace; kernels/build.py hashes this header into the
// digest of every source that includes it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;      // threads per CTA, all kernels
constexpr int kMaxCtas = 1024;     // reduction CTAs (partials per sum)
constexpr int kMaxEwCtas = 132 * 16;  // elementwise CTAs: 16 per SM

__device__ __forceinline__ float ld(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void st(__half* p, int64_t i, float v) {
  p[i] = __float2half_rn(v);
}

// Sum over the CTA in a fixed order; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* smem) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // smem may still be read from an earlier call
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  v = 0.0f;
  if (warp == 0) {
    if (lane < kThreads / 32) v = smem[lane];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

int reduce_ctas(int64_t n) {
  int64_t c = (n + kThreads * 8 - 1) / (kThreads * 8);
  if (c < 1) c = 1;
  return static_cast<int>(c < kMaxCtas ? c : kMaxCtas);
}

int elementwise_ctas(int64_t n) {
  int64_t c = (n + kThreads - 1) / kThreads;
  if (c < 1) c = 1;
  return static_cast<int>(c < kMaxEwCtas ? c : kMaxEwCtas);
}

// Second pass, one CTA: out[k] = sum of parts[k * n_parts .. + n_parts) for
// k < n_sums, then zeros up to n_out.
__global__ void __launch_bounds__(kThreads)
finish_sums_kernel(const float* __restrict__ parts, int n_parts, int n_sums,
                   float* __restrict__ out, int n_out) {
  __shared__ float smem[kThreads / 32];
  for (int k = 0; k < n_sums; ++k) {
    float acc = 0.0f;
    for (int i = threadIdx.x; i < n_parts; i += kThreads)
      acc += parts[k * n_parts + i];
    acc = block_sum(acc, smem);
    if (threadIdx.x == 0) out[k] = acc;
  }
  if (threadIdx.x >= n_sums && threadIdx.x < n_out) out[threadIdx.x] = 0.0f;
}

struct Consts {
  float beta1, one_minus_beta1, beta2, one_minus_beta2, eps;
};

// trust ratio ||x|| / ||u||, selecting 1 where ||u||^2 is 0 or trust is off
__device__ __forceinline__ float trust_ratio(float x_norm, float u_sq,
                                             float trust) {
  const float s = u_sq > 0.0f ? x_norm * rsqrtf(fmaxf(u_sq, 1e-38f)) : 1.0f;
  return trust > 0.0f ? s : 1.0f;
}

}  // namespace
