"""Share of the (token, expert) pairs routed in the stretch traced without
stacks that were past their expert's capacity and dropped: the port's
counters moe.pairs_dropped over moe.pairs_routed (models/moe.py), their
change over the stretch, in percent."""
LAYER = "MoE (models/moe.py)"
UNIT = "%"
MOVES = "train_tokens_per_s"
SOURCE = "program_counter"


def read(ctx):
    return ctx.span_readings().get("moe_drop_share")
