"""Host time of a training step's model, forward and backward: the
program's ``model.forward`` span, plus ``trainer.backward`` less the
kernels' backward that it encloses (``mc.mean_fidelity.backward``), over
the traced steps."""

from port_bench import spans


def read(ctx, records=None):
    return spans.per_unit_ms(ctx, "step", "trainer.step", whole=("model.forward",),
                             own=("trainer.backward",), records=records)
