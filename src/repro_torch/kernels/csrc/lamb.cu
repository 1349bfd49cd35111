// The fused LAMB optimizer step for Hopper (sm_90a): two kernels K5-K6.
//
// Replaces the TPU kernels of src/repro/kernels/lamb_kernel.py:
//   K5 lamb_phase1   (_lamb_phase1_kernel)  g * clip, new m and v, partial
//                    ||u||^2 and ||x||^2 with u = (m~ / (sqrt(v~) + eps))
//                    + lam x
//   K6 lamb_phase2   (_lamb_phase2_kernel)  trust = ||x|| / ||u||,
//                    x <- x - eta * trust * u in x's dtype
// The plain PyTorch versions they are held to are in
// repro_torch/kernels/lamb.py (*_plain).
//
// What bounds them on an H100: bytes. K5 reads g, m, v, x and writes m, v
// (24 B per fp32 parameter); K6 reads m, v, x and writes x (16 B), against
// a handful of flops per element. So each kernel reads each operand once
// and writes each output once, with fp32 arithmetic in registers whatever
// the storage dtype, in the design of lans.cu:
//   * flat tensors of any length, grid-stride loops with 64-bit offsets and
//     a bound-checked tail; nothing is padded;
//   * K5's sums are deterministic: per-CTA partials (at most kMaxCtas), then
//     a one-CTA finishing launch adds them in a fixed order into the 8-float
//     norms array [||u||^2, ||x||^2, 0 x 6] that K6 reads. No float atomics,
//     so K5 repeats bit for bit;
//   * the scalars are an 8-float device array laid out as the TPU's (1, 8)
//     operand, [bc1, bc2, eta, lam, trust_flag, clip, 0, 0] (slot 5 is the
//     global clip factor, where LANS keeps g_sq), so a step reads nothing
//     back to the host;
//   * guards as the reference's: K5 has none (a NaN in g makes m, v and the
//     norms NaN); K6 selects, it does not multiply: trust is
//     ||x|| * rsqrt(||u||^2) where ||u||^2 > 0, else 1 (NaN > 0 is false,
//     so a NaN norm gives 1), and 1 when the trust flag is off.
// The launch sizes, loads and stores, CTA sum, finishing pass and trust
// ratio are lans.cu's, from optim_common.cuh.
#include "optim_common.cuh"

namespace {

// u = (m / bc1) / (sqrt(v / bc2) + eps) + lam * x, as the TPU kernels group it
__device__ __forceinline__ float lamb_u(float m, float v, float x, float bc1,
                                        float bc2, float lam, float eps) {
  return (m / bc1) / (sqrtf(v / bc2) + eps) + lam * x;
}

// ---------------------------------------------------------------------------
// K5: moments and partial norms
// ---------------------------------------------------------------------------
template <typename TG, typename TX>
__global__ void __launch_bounds__(kThreads)
lamb_phase1_kernel(const float* __restrict__ scal, const TG* __restrict__ g,
                   const float* __restrict__ m, const float* __restrict__ v,
                   const TX* __restrict__ x, float* __restrict__ m_out,
                   float* __restrict__ v_out, int64_t n, Consts k,
                   float* __restrict__ parts) {
  __shared__ float smem[kThreads / 32];
  const float bc1 = scal[0], bc2 = scal[1], lam = scal[3], clip = scal[5];
  float u_acc = 0.0f, x_acc = 0.0f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const float gi = ld(g, i) * clip;
    const float xi = ld(x, i);
    const float mn = k.beta1 * m[i] + k.one_minus_beta1 * gi;
    const float vn = k.beta2 * v[i] + k.one_minus_beta2 * (gi * gi);
    m_out[i] = mn;
    v_out[i] = vn;
    const float u = lamb_u(mn, vn, xi, bc1, bc2, lam, k.eps);
    u_acc += u * u;
    x_acc += xi * xi;
  }
  u_acc = block_sum(u_acc, smem);
  x_acc = block_sum(x_acc, smem);
  if (threadIdx.x == 0) {
    parts[blockIdx.x] = u_acc;
    parts[gridDim.x + blockIdx.x] = x_acc;
  }
}

// ---------------------------------------------------------------------------
// K6: apply the trust-scaled update
// ---------------------------------------------------------------------------
template <typename TX>
__global__ void __launch_bounds__(kThreads)
lamb_phase2_kernel(const float* __restrict__ scal,
                   const float* __restrict__ norms,
                   const float* __restrict__ m, const float* __restrict__ v,
                   const TX* __restrict__ x, TX* __restrict__ x_out,
                   int64_t n, float eps) {
  const float bc1 = scal[0], bc2 = scal[1], eta = scal[2], lam = scal[3];
  const float trust = trust_ratio(sqrtf(norms[1]), norms[0], scal[4]);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const float xi = ld(x, i);
    const float u = lamb_u(m[i], v[i], xi, bc1, bc2, lam, eps);
    st(x_out, i, xi - eta * trust * u);
  }
}

template <typename TG, typename TX>
cudaError_t launch_phase1(const float* scal, const void* g, const float* m,
                          const float* v, const void* x, float* m_out,
                          float* v_out, int64_t n, Consts k, float* parts,
                          float* norms, cudaStream_t st) {
  const int ctas = reduce_ctas(n);
  lamb_phase1_kernel<TG, TX><<<ctas, kThreads, 0, st>>>(
      scal, static_cast<const TG*>(g), m, v, static_cast<const TX*>(x), m_out,
      v_out, n, k, parts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  finish_sums_kernel<<<1, kThreads, 0, st>>>(parts, ctas, 2, norms, 8);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t launch_phase2(const float* scal, const float* norms,
                          const float* m, const float* v, const void* x,
                          void* x_out, int64_t n, float eps, cudaStream_t st) {
  lamb_phase2_kernel<TX><<<elementwise_ctas(n), kThreads, 0, st>>>(
      scal, norms, m, v, static_cast<const TX*>(x), static_cast<TX*>(x_out),
      n, eps);
  return cudaGetLastError();
}

}  // namespace

// Every launcher returns a cudaError_t (0 when its launches were accepted).
// dtype codes: 0 fp32, 1 bf16. `parts` is scratch of at least
// 2 * lamb_max_parts() floats.

extern "C" int lamb_max_parts() { return kMaxCtas; }

// K5: m_out, v_out and norms[0..7] = [u_sq, x_sq, 0, 0, 0, 0, 0, 0].
extern "C" int lamb_phase1_launch(const float* scal, const void* g,
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

// K6: x_out = x - eta * trust * u in x's dtype.
extern "C" int lamb_phase2_launch(const float* scal, const float* norms,
                                  const float* m, const float* v,
                                  const void* x, int x_dtype, void* x_out,
                                  int64_t n, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_dtype == 1
          ? launch_phase2<__nv_bfloat16>(scal, norms, m, v, x, x_out, n, eps,
                                         st)
          : launch_phase2<float>(scal, norms, m, v, x, x_out, n, eps, st);
  return static_cast<int>(err);
}
