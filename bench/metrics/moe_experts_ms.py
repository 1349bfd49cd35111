"""Device ms a step of the "model.moe.experts" span (moe_apply's dispatch,
expert MLPs and combine, the expert-count sync in it) in every pass
(harness/spans.py over the stretch traced without stacks)."""
LAYER = "MoE (models/moe.py)"
UNIT = "ms"
MOVES = "train_tokens_per_s"
SOURCE = "program_span"


def read(ctx):
    return ctx.span_readings().get("moe_experts_ms")
