"""The LANS kernels' share of their memory roofline: the bytes the mixed
update needs (cost/lans.py: each buffer read and written once at the
configuration's dtypes) at 3.35 TB/s, over the device time of the
kernels of kernels/csrc/lans.cu alone (K1 sq_norm, K2 lans_phase1, K4
lans_phase2 with its cast) that the optimizer launched, in percent. The
rest of the optimizer's time (the gradient norm's and the finite flag's
aten ops, the copy's update) is in lans_update_ms and not here."""
from bench.harness.peaks import HBM_BYTES_PER_S

LAYER = "Kernels (kernels/csrc/lans.cu K1, K2, K4)"
UNIT = "%"
MOVES = "train_tokens_per_s"
SOURCE = "device_trace"
# the kernels' names in lans.cu, as parts of the device ops' names
KERNELS = ("sq_norm_kernel", "lans_phase1_kernel", "lans_phase2_kernel")


def read(ctx):
    us = sum(o.dur for o in ctx.ops if "lans_update_ms" in o.tags
             and any(k in o.name for k in KERNELS)) / ctx.traced_steps
    if us <= 0:
        return None
    return 100.0 * (ctx.lans_bytes / HBM_BYTES_PER_S) / (us / 1e6)
