"""Host time of a training step's Monte-Carlo objective, forward and
backward (the program's ``mc.mean_fidelity`` and
``mc.mean_fidelity.backward`` spans), over the traced steps."""

from port_bench import spans


def read(ctx, records=None):
    return spans.per_unit_ms(ctx, "step", "trainer.step",
                             whole=("mc.mean_fidelity", "mc.mean_fidelity.backward"),
                             records=records)
