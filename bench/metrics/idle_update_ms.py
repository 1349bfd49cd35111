"""Idle ms a step of the card in gaps that begin inside the step's
"train.update" span on the main thread (distributed/steps.py: the
gradient norm and the transform; harness/spans.py over the stretch
traced without stacks)."""
LAYER = "Train step (distributed/steps.py)"
UNIT = "ms"
MOVES = "train_tokens_per_s"
SOURCE = "program_span"


def read(ctx):
    return ctx.span_readings().get("idle_update_ms")
