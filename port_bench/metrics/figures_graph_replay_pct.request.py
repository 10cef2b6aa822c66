"""Share of a serving request's figure calls (the program's
``plots.fidelity_grid``, ``plots.fidelity_by_std`` and
``plots.mc_fidelity_estimate`` spans) that replayed a CUDA graph captured
at an earlier call: the count of the program's ``plots.graph_replay`` spans
over the count of those calls in the traced requests, in %, where
``model.forward`` opened once a request.  Nothing where no figure call
replayed one, as in a program whose figures run eagerly."""

from port_bench import spans

FIGURES = ("plots.fidelity_grid", "plots.fidelity_by_std", "plots.mc_fidelity_estimate")


def read(ctx, records=None):
    tr, tracing = ctx["trace"], spans._tracing()
    if ctx["unit"] != "request" or not tr or not tr["units"] or tracing is None:
        return None
    sums = tracing.totals(records)
    calls = sum(sums[n]["count"] for n in FIGURES if n in sums)
    if (sums.get("model.forward", {}).get("count") != tr["units"] or not calls
            or "plots.graph_replay" not in sums):
        return None
    return 100.0 * sums["plots.graph_replay"]["count"] / calls
