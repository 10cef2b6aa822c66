"""Host time of a serving request's figures (the program's
``plots.fidelity_grid``, ``plots.fidelity_by_std`` and
``plots.mc_fidelity_estimate`` spans), over the traced requests."""

from port_bench import spans


def read(ctx, records=None):
    return spans.per_unit_ms(
        ctx, "request", "model.forward",
        whole=("plots.fidelity_grid", "plots.fidelity_by_std", "plots.mc_fidelity_estimate"),
        records=records)
