"""The SU(4) Monte-Carlo work's share of its roofline, per request (the
sweep and the grid through B7)."""

from port_bench import readers


def read(ctx):
    return readers.roofline_pct(ctx, "request", "su4")
