"""torch.cuda.max_memory_allocated() over the window, in GiB."""
LAYER = "Device (H100)"
UNIT = "GiB"
MOVES = "train_tokens_per_s"
SOURCE = "program_counter"


def read(ctx):
    return ctx.window_peak_bytes / 2 ** 30 if ctx.window_peak_bytes else None
