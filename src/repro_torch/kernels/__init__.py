"""Hand-written Hopper kernels of the port, each beside its plain version.

  paged_attention   paged decode attention: K8 with the K/V/pos write
                    fused in, and K7, its read side (CUDA,
                    csrc/paged_attention.cu)
  lans              the fused LANS step, K1-K4 (CUDA, csrc/lans.cu)
  lamb              the fused LAMB step, K5-K6 (CUDA, csrc/lamb.cu)
  ops               per-tensor fused optimizer steps over those kernels
  build             nvcc build of csrc/*.cu and ctypes loading

A wrapper sends CPU tensors to the plain version and CUDA tensors to the
kernel; it never falls back from one to the other.
"""

# Masked-logit value shared by the kernel's plain version and the model's
# attention paths. It must stay FINITE: exp(NEG_INF - m) underflows to
# exactly 0, where -inf would give inf - inf = NaN for a row with no
# valid key.
NEG_INF = -2.3819763e38
