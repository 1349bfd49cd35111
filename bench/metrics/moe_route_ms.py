"""Device ms a step of the "model.moe.route" span (models/moe.py:moe_apply's
router, top k, capacity positions, kept pairs and aux terms) in every
pass (harness/spans.py over the stretch traced without stacks)."""
LAYER = "MoE (models/moe.py)"
UNIT = "ms"
MOVES = "train_tokens_per_s"
SOURCE = "program_span"


def read(ctx):
    return ctx.span_readings().get("moe_route_ms")
