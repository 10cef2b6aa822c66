"""The SU(2) Monte-Carlo work's share of its roofline, per request (product
and fidelity)."""

from port_bench import readers


def read(ctx):
    return readers.roofline_pct(ctx, "request", "su2")
