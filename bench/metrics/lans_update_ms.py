"""Device ms a step of the kernels launched inside the optimizer's part
of the step: the train step's update (gradient norm, the transform, the
params' update) and the fused LANS transform and its kernels (K1, K2,
K4)."""
LAYER = "Optimizer (precision/fused.py, core/optim/fused.py, kernels/lans.py)"
UNIT = "ms"
MOVES = "train_tokens_per_s"
SOURCE = "device_trace"
MODULES = ("repro_torch/distributed/steps.py:update",
           "repro_torch/precision/fused.py",
           "repro_torch/core/optim/fused.py",
           "repro_torch/kernels/lans.py",
           "repro_torch/kernels/ops.py")


def read(ctx):
    ms = ctx.tagged_ms("lans_update_ms")
    return ms if ms > 0 else None
