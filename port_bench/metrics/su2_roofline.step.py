"""The SU(2) Monte-Carlo work's share of its roofline, per training step
(product, fidelity and the reverse sweep)."""

from port_bench import readers


def read(ctx):
    return readers.roofline_pct(ctx, "step", "su2")
