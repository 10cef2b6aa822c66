"""Share of the traced serving requests whose model forward replayed a CUDA
graph captured at an earlier request: the count of the program's
``model.graph_replay`` spans over the traced requests, in %, where
``model.forward`` opened once a request.  Nothing where no traced request
replayed one, as in a program whose forward runs eagerly."""

from port_bench import spans


def read(ctx, records=None):
    tr, tracing = ctx["trace"], spans._tracing()
    if ctx["unit"] != "request" or not tr or not tr["units"] or tracing is None:
        return None
    sums = tracing.totals(records)
    if (sums.get("model.forward", {}).get("count") != tr["units"]
            or "model.graph_replay" not in sums):
        return None
    return 100.0 * sums["model.graph_replay"]["count"] / tr["units"]
