"""Host time of a training step's clip and Adam (the program's
``trainer.optimizer`` span), over the traced steps."""

from port_bench import spans


def read(ctx, records=None):
    return spans.per_unit_ms(ctx, "step", "trainer.step", whole=("trainer.optimizer",),
                             records=records)
