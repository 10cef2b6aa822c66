"""The arithmetic of the readers of the program's own spans.

The program records its spans (``utils/tracing.py``: ``trainer.step``,
``model.forward``, ...) while a profiler records, which in a run of the
benchmark is the traced sub-window alone; its list then holds exactly the
traced units.  A reader sums some names' host time, whole or less the part
their children cover (the program's ``tracing.totals``), over the units.
It returns ``None`` for another kind of unit, for a program that records
no spans, and where the count of the unit's root span is not the number
of traced units.
"""

from typing import Iterable, List, Optional


def _tracing():
    try:
        from universal_quantum_optimal_control_tpu_torch.utils import tracing
    except ImportError:   # a program from before its spans
        return None
    return tracing


def per_unit_ms(ctx, unit: str, root: str, whole: Iterable[str] = (),
                own: Iterable[str] = (), records: Optional[List] = None):
    """Milliseconds a traced unit: the total time of the names in ``whole``
    plus the self time of those in ``own``, over the traced units, where
    ``root`` opened once a unit; ``records`` defaults to the program's."""
    tr, tracing = ctx["trace"], _tracing()
    if ctx["unit"] != unit or not tr or not tr["units"] or tracing is None:
        return None
    sums = tracing.totals(records)
    if sums.get(root, {}).get("count") != tr["units"]:
        return None
    total = (sum(sums[n]["total_s"] for n in whole if n in sums)
             + sum(sums[n]["self_s"] for n in own if n in sums))
    return 1e3 * total / tr["units"]
