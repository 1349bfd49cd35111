"""Device ms a step of the kernels launched beneath models/moe.py's frames
(routing, dispatch and the experts, forward and recomputation): a part
of fwd_bwd_ms."""
LAYER = "MoE (models/moe.py)"
UNIT = "ms"
MOVES = "train_tokens_per_s"
SOURCE = "device_trace"
MODULES = ("repro_torch/models/moe.py",)


def read(ctx):
    ms = ctx.tagged_ms("moe_fwd_ms")
    return ms if ms > 0 else None
