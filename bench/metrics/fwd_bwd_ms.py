"""Device ms a step of every device operation that is neither the
optimizer's (lans_update_ms) nor an NCCL collective: the
forward and backward passes, the batch's copy to the card and the
loss."""
LAYER = "Model (models/bert.py, models/decoder.py, models/common.py)"
UNIT = "ms"
MOVES = "train_tokens_per_s"
SOURCE = "device_trace"


def read(ctx):
    us = sum(o.dur for o in ctx.ops
             if "lans_update_ms" not in o.tags and not o.nccl)
    return us / 1e3 / ctx.traced_steps if us > 0 else None
