"""Share of a profiled stretch's wall time in which no operation ran on
the card (one minus the union of the device operations' intervals
over the stretch), in percent; the stretch is profiled without Python
stacks, so that the host runs at its own pace."""
LAYER = "Device (H100)"
UNIT = "%"
MOVES = "train_tokens_per_s"
SOURCE = "device_trace"


def read(ctx):
    tl = ctx.timeline
    if tl is None or tl.window_us <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_us / tl.window_us)
