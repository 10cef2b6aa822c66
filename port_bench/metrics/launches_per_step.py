"""Kernels launched a training step (exact)."""

from port_bench import readers


def read(ctx):
    return readers.launches(ctx, "step")
