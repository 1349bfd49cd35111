"""Host wall time of one call of the train step, from the call to its
return, median over the window's steps (the profiled stretches run
after the window and are not among them)."""
import statistics

LAYER = "Train step (distributed/steps.py)"
UNIT = "ms"
MOVES = "train_tokens_per_s"
SOURCE = "host_clock"


def read(ctx):
    return statistics.median(ctx.host_s) * 1e3 if ctx.host_s else None
