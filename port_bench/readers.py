"""The arithmetic of the per-layer metric readers.  Each reader
(``metrics/<name>.py``) applies one of these to the traced run's context
for one kind of unit, "step" or "request"; each returns ``None`` where the
run has nothing to read: another kind of unit, another family of kernels,
or an empty trace."""

from port_bench.work import PEAK_F32, bound_s


def launches(ctx, unit):
    """Every device kernel in the traced sub-window over its units (exact)."""
    tr = ctx["trace"]
    if ctx["unit"] != unit or not tr or not tr["kernels"]:
        return None
    return tr["kernels"] / tr["units"]


def idle_pct(ctx, unit):
    """One minus the union of the device operations' intervals over the
    traced sub-window, in which units run back to back."""
    tr = ctx["trace"]
    if ctx["unit"] != unit or not tr or tr["busy_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def mfu_pct(ctx, unit):
    """The whole unit's share of the chip's peak: the model's matmul flops
    at the peak of the dtype the encoder computes in, plus the Monte-Carlo
    work's flops at the f32 peak, over the untraced window's time a unit."""
    work = ctx["work"]
    if ctx["unit"] != unit or not ctx["unit_s"] > 0.0:
        return None
    ideal = work["model_flops"] / work["model_peak"] + work["mc"]["flops"] / PEAK_F32
    return 100.0 * ideal / ctx["unit_s"]


def roofline_pct(ctx, unit, family):
    """The ``family`` ("su2" or "su4") Monte-Carlo work's share of its
    roofline: the least time the chip could take for the work the unit's
    inputs need (counted once, :mod:`port_bench.work`), over the device time
    of the program's own kernels in the traced sub-window."""
    tr, work = ctx["trace"], ctx["work"]
    if (ctx["unit"] != unit or work["family"] != family or not tr
            or tr["port_kernel_s"] <= 0.0):
        return None
    bound = bound_s(work["mc"]["flops"], work["mc"]["bytes"]) * tr["units"]
    return 100.0 * bound / tr["port_kernel_s"]


def device_ms(ctx, unit, cls):
    """Device time of one class of operations (:data:`port_bench.trace.CLASSES`)
    in the traced sub-window, in milliseconds a unit."""
    tr = ctx["trace"]
    if ctx["unit"] != unit or not tr or not tr.get("by_class", {}).get(cls):
        return None
    return 1e3 * tr["by_class"][cls] / tr["units"]
