"""The whole training step's share of the chip's peak."""

from port_bench import readers


def read(ctx):
    return readers.mfu_pct(ctx, "step")
