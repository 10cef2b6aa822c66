r"""Named host spans of the training step and the serving request, recorded
while a ``torch.profiler`` records.

A span is on exactly while a profiler records (``TrainConfig.profile_dir``
or any ``torch.profiler.profile`` around the call); there is no other
switch.  Off, :func:`span` costs one check of the profiler's flag and
returns a shared no-op context.  On, it does two things:

* it enters ``torch.profiler.record_function(name)``, so the span lands in
  the profiler's trace (``trace.json``) beside the kernels it launched, on
  the profiler's one clock;
* it appends a :class:`Span` to an in-memory list (:func:`recorded`): the
  name, the host clock at entry and exit, the enclosing span and the unit,
  which is the outermost span's index (a training step, a request).

A span adds no synchronisation, no host read and no kernel: its duration
is host time, which is what paces a step whose device waits on the host.
Device time by span is read from the trace.  Nothing is written to disk.

The spans of the port, and the layer each times:

=============================  =============================================
``trainer.step``               ``Trainer.train_step``: one optimizer step
``trainer.backward``           ``loss.backward()`` inside the step
``trainer.optimizer``          ``Trainer.apply_gradients``: clip, then Adam
``trainer.graph_replay``       a step that replays its CUDA graph, opened
                               by the shared cache (``ops/graphs.py``): the
                               inputs' copies, the learning rate's write,
                               the replay, inside which no other span
                               opens (no Python runs there), and the
                               outputs' copies
``model.forward``              the pulse models' ``forward``
``model.graph_replay``         a forward that replays its CUDA graph, opened
                               by the same cache: the input's copy, the
                               replay and the output's copy
``mc.mean_fidelity``           the Monte-Carlo objective's forward, either
                               backend
``mc.mean_fidelity.backward``  the kernels' backward (B3 + B2, or B5)
``plots.fidelity_grid``,       the figures' numbers
``plots.fidelity_by_std``,
``plots.mc_fidelity_estimate``
``plots.graph_replay``         a figure call that replays its CUDA graph,
                               opened by the same cache inside the
                               figure's span: the inputs' copies, the
                               draws' reseed, the replay and the output's
                               copy
=============================  =============================================

Spans opened inside a backward that runs on autograd's device thread,
which has no open span of its own, nest under the span opened with
``backward=True`` around the ``backward()`` call.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time
from typing import Dict, List, Optional

import torch

__all__ = ["Span", "span", "recorded", "clear", "totals"]


@dataclasses.dataclass(slots=True)
class Span:
    """One recorded span; ``parent`` and ``unit`` index :func:`recorded`,
    ``end_ns`` is None while the span is open."""

    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: Optional[int]
    unit: int


_RECORDS: List[Span] = []
_LOCK = threading.Lock()
_LOCAL = threading.local()     # .stack: the spans open on this thread
_BACKWARD: List[int] = []      # the open spans around a backward() call
_OFF: Dict[str, "_Off"] = {}


class _Named:
    __slots__ = ("name",)

    def __init__(self, name: str) -> None:
        self.name = name

    def __call__(self, fn):
        """As a decorator: a span around each call of ``fn``, on or off as
        the profiler is at that call."""
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return spanned


class _Off(_Named):
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


class _On(_Named):
    __slots__ = ("backward", "index", "annotation")

    def __init__(self, name: str, backward: bool) -> None:
        super().__init__(name)
        self.backward = backward

    def __enter__(self) -> None:
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        parent = stack[-1] if stack else (_BACKWARD[-1] if _BACKWARD else None)
        self.annotation = torch.profiler.record_function(self.name)
        self.annotation.__enter__()
        with _LOCK:
            index = len(_RECORDS)
            unit = index if parent is None else _RECORDS[parent].unit
            _RECORDS.append(Span(self.name, time.perf_counter_ns(), None, parent, unit))
        stack.append(index)
        if self.backward:
            _BACKWARD.append(index)
        self.index = index

    def __exit__(self, *exc) -> bool:
        _RECORDS[self.index].end_ns = time.perf_counter_ns()
        _LOCAL.stack.pop()
        if self.backward:
            _BACKWARD.remove(self.index)
        self.annotation.__exit__(*exc)
        return False


def span(name: str, backward: bool = False):
    """A context (or decorator) that records the span ``name`` while a
    profiler records, and does nothing otherwise.  ``backward=True`` marks
    a span around an autograd ``backward()`` call (used with ``with``):
    spans opened by the backward on autograd's own threads nest under it."""
    if torch.autograd._profiler_enabled():
        return _On(name, backward)
    off = _OFF.get(name)
    if off is None:
        off = _OFF[name] = _Off(name)
    return off


def recorded() -> List[Span]:
    """Every span recorded since the last :func:`clear`, in order of entry."""
    return _RECORDS


def clear() -> None:
    """Forget the recorded spans (call with no span open)."""
    with _LOCK:
        _RECORDS.clear()


def totals(spans: Optional[List[Span]] = None) -> Dict[str, Dict[str, float]]:
    """Each name's ``count``, ``total_s`` and ``self_s`` over the closed
    spans of ``spans`` (default: :func:`recorded`).  A span's self time is
    its duration less the part of it that its children cover."""
    spans = _RECORDS if spans is None else spans
    children: Dict[int, List[Span]] = {}
    for s in spans:
        if s.parent is not None and s.end_ns is not None:
            children.setdefault(s.parent, []).append(s)
    out: Dict[str, Dict[str, float]] = {}
    for i, s in enumerate(spans):
        if s.end_ns is None:
            continue
        covered, reach = 0, s.start_ns
        for c in sorted(children.get(i, ()), key=lambda c: c.start_ns):
            a, b = max(c.start_ns, reach), min(c.end_ns, s.end_ns)
            if b > a:
                covered += b - a
                reach = b
        t = out.setdefault(s.name, {"count": 0, "total_s": 0.0, "self_s": 0.0})
        t["count"] += 1
        t["total_s"] += (s.end_ns - s.start_ns) * 1e-9
        t["self_s"] += (s.end_ns - s.start_ns - covered) * 1e-9
    return out
