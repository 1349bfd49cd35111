"""Hand-written Hopper kernels of the port, each beside its plain version.

  paged_attention   paged decode attention with the K/V/pos write fused
                    in (CUDA, csrc/paged_attention.cu) and its plain
                    PyTorch version
  build             nvcc build of csrc/*.cu and ctypes loading

A wrapper sends CPU tensors to the plain version and CUDA tensors to the
kernel; it never falls back from one to the other.
"""

# Masked-logit value shared by the kernel's plain version and the model's
# attention paths. It must stay FINITE: exp(NEG_INF - m) underflows to
# exactly 0, where -inf would give inf - inf = NaN for a row with no
# valid key.
NEG_INF = -2.3819763e38
