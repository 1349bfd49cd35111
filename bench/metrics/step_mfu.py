"""The whole step's share of the chips' bf16 peak: the benchmark's own
count of model FLOPs (cost/<kind>.py) of every step of the window, over
the window's seconds x the peak x the chips, in percent."""
from bench.harness.peaks import BF16_FLOPS

LAYER = "Train step (distributed/steps.py)"
UNIT = "%"
MOVES = "train_tokens_per_s"
SOURCE = "host_clock"


def read(ctx):
    if not ctx.window_s:
        return None
    return 100.0 * ctx.window_flops / (ctx.window_s * BF16_FLOPS * ctx.chips)
