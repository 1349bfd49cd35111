"""Host wall ms a step inside the "sync.*" spans, where the host waits for
a value from the card: the step's finite flag (precision/mixed.py:
read_finite) and the MoE's expert counts (models/moe.py:_expert_counts)
(harness/spans.py over the stretch traced without stacks)."""
LAYER = "Host syncs (precision/mixed.py:read_finite, models/moe.py:_expert_counts)"
UNIT = "ms"
MOVES = "train_tokens_per_s"
SOURCE = "program_span"


def read(ctx):
    return ctx.span_readings().get("host_sync_ms")
