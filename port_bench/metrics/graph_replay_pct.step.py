"""Share of the traced training steps that replayed a CUDA graph captured
at an earlier step: the count of the program's ``trainer.graph_replay``
spans over the traced steps, in %.  Nothing where no traced step replayed
one, as in a program that runs its steps eagerly."""

from port_bench import spans


def read(ctx, records=None):
    tr, tracing = ctx["trace"], spans._tracing()
    if ctx["unit"] != "step" or not tr or not tr["units"] or tracing is None:
        return None
    sums = tracing.totals(records)
    if (sums.get("trainer.step", {}).get("count") != tr["units"]
            or "trainer.graph_replay" not in sums):
        return None
    return 100.0 * sums["trainer.graph_replay"]["count"] / tr["units"]
