"""Device ms a step of the kernels launched beneath models/attention.py's
frames (its forward, and its recomputation in the backward pass where
that runs Python): a part of fwd_bwd_ms."""
LAYER = "Attention (models/attention.py)"
UNIT = "ms"
MOVES = "train_tokens_per_s"
SOURCE = "device_trace"
MODULES = ("repro_torch/models/attention.py",)


def read(ctx):
    ms = ctx.tagged_ms("attention_fwd_ms")
    return ms if ms > 0 else None
