"""Device ms a step of the "model.head" span, forward and backward: BERT's
MLM and NSP heads and their loss, a decoder's readout and its loss
(models/bert.py, models/decoder.py; harness/spans.py over the stretch
traced without stacks)."""
LAYER = "Model (models/bert.py, models/decoder.py, models/common.py)"
UNIT = "ms"
MOVES = "train_tokens_per_s"
SOURCE = "program_span"


def read(ctx):
    return ctx.span_readings().get("head_ms")
