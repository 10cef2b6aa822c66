"""Host time of a serving request's model forward (the program's
``model.forward`` span), over the traced requests; unlike
``model_ms.request`` it leaves out the wait for the device at the copy."""

from port_bench import spans


def read(ctx, records=None):
    return spans.per_unit_ms(ctx, "request", "model.forward", whole=("model.forward",),
                             records=records)
