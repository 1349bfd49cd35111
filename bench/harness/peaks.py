"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the 700 W power limit)."""
BF16_FLOPS = 989e12        # tensor cores, bf16 and fp16
HBM_BYTES_PER_S = 3.35e12  # HBM3
