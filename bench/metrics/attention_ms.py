"""Device ms a step of the "model.attention" span (models/attention.py:
attn_apply) and the spans in it, in its forward pass, its recomputation
in the backward pass and its backward pass (harness/spans.py over the
stretch traced without stacks)."""
LAYER = "Attention (models/attention.py)"
UNIT = "ms"
MOVES = "train_tokens_per_s"
SOURCE = "program_span"


def read(ctx):
    return ctx.span_readings().get("attention_ms")
