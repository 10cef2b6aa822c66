"""The device's idle share while training steps run back to back."""

from port_bench import readers


def read(ctx):
    return readers.idle_pct(ctx, "step")
