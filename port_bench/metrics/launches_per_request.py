"""Kernels launched a request (exact)."""

from port_bench import readers


def read(ctx):
    return readers.launches(ctx, "request")
