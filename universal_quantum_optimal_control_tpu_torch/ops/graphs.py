r"""The port's one cache of CUDA graphs.

A call that a caller may graph (the trainer's step,
:meth:`..training.trainer.Trainer.train_step`; the pulse models' eval
forward, :class:`..models.universal_transformer.PulseTransformer`) is
captured once for each key and then replayed, so the host issues one launch
where the eager call issues some hundreds or thousands.  The caller decides
when a call is graphed and what its key is; the cache does the rest.  For
each key:

* the first call runs the caller's eager callable on a side stream (the
  warm-up: cuBLAS's handle and workspace for that stream, Adam's state);
* the second captures the caller's body there, reading static inputs
  shaped as the call's (``thread_local`` mode: other threads may run CUDA
  work meanwhile), with the caller's generators registered, so that the
  graph's random draws continue their streams; then it runs the graph once;
* every later call copies its inputs into the static ones, runs the
  caller's host work, replays inside a span of the cache's name and returns
  copies of the static outputs, which the next replay rewrites.

A capture launches nothing: the launches that the counting wrappers of
:data:`..ops.COUNTED` record while the body is captured move to each run
of the graph.  At most :attr:`GraphCache.limit` keys are kept, the least
recently used dropped first.  A lock serialises the cache, since a served
model may be called from several threads.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from ..utils.tracing import span
from . import COUNTED

__all__ = ["GraphCache"]


@dataclasses.dataclass(frozen=True)
class _Graph:
    """One captured body: the graph, the static inputs it reads, the static
    outputs it writes (``single``: the body returned one tensor, not a
    tuple) and the kernel launches it holds (counting wrapper, count)."""

    graph: Any
    inputs: Tuple[torch.Tensor, ...]
    outputs: Tuple[torch.Tensor, ...]
    single: bool
    launches: Tuple[Tuple[Any, int], ...]

    def run(self, inputs: Sequence[torch.Tensor], before: Optional[Callable[[], None]]):
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src)
        if before is not None:
            before()
        self.graph.replay()
        for f, n in self.launches:
            f.launches += n
        if self.single:
            return self.outputs[0].clone()
        return tuple(t.clone() for t in self.outputs)


class GraphCache:
    """The CUDA graphs of one owner (see the module's docstring); a replay
    opens the span ``span_name``.  ``captures`` and ``replays`` count the
    calls that captured a graph and those that replayed one captured at an
    earlier call.  A copy or a pickle of the owner starts with no graphs."""

    limit = 8     # keys kept: eval CLIs that sweep batch sizes keep a few pools

    def __init__(self, span_name: str) -> None:
        self.span_name = span_name
        self._graphs: "OrderedDict[tuple, Optional[_Graph]]" = OrderedDict()
        self._side: Optional[torch.cuda.Stream] = None
        self._lock = threading.Lock()
        self.captures = 0
        self.replays = 0

    def __reduce__(self):
        return GraphCache, (self.span_name,)

    def clear(self) -> None:
        """Drop every graph (and the side stream, made anew on the next
        warm-up's device)."""
        with self._lock:
            self._graphs.clear()
            self._side = None

    def __call__(self, key: tuple, inputs: Sequence[torch.Tensor], eager: Callable,
                 body: Callable, before: Optional[Callable[[], None]] = None,
                 generators: Sequence[torch.Generator] = ()):
        """``eager(*inputs)`` or the graph of ``body`` run on ``inputs``, as
        the calls with ``key`` so far decide.  ``body`` must read nothing
        but its arguments, tensors whose storage stays, and ``generators``;
        ``before()`` is the caller's host work before each run of the graph."""
        with self._lock:
            if key in self._graphs:
                self._graphs.move_to_end(key)
                graph = self._graphs[key]
                if graph is not None:
                    # a replay runs on its graph's card, whatever the current one
                    with span(self.span_name):
                        out = graph.run(inputs, before)
                    self.replays += 1
                    return out
            with torch.cuda.device(inputs[0].device):
                if key not in self._graphs:
                    out = self._warm_up(eager, inputs)
                    self._graphs[key] = None
                    if len(self._graphs) > self.limit:
                        self._graphs.popitem(last=False)
                    return out
                graph = self._graphs[key] = self._capture(body, inputs, generators)
            self.captures += 1
            return graph.run(inputs, before)

    def _side_stream(self) -> torch.cuda.Stream:
        if self._side is None:
            self._side = torch.cuda.Stream()
        return self._side

    def _warm_up(self, eager: Callable, inputs: Sequence[torch.Tensor]):
        """The eager call on the stream that will capture."""
        current, side = torch.cuda.current_stream(), self._side_stream()
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = eager(*inputs)
        current.wait_stream(side)
        return out

    def _capture(self, body: Callable, inputs: Sequence[torch.Tensor],
                 generators: Sequence[torch.Generator]) -> _Graph:
        """Capture ``body`` on static copies of ``inputs``; the wrappers'
        launch counts move from the capture to the graph's runs."""
        static = tuple(t.clone(memory_format=torch.contiguous_format) for t in inputs)
        counts = [f.launches for f in COUNTED]
        graph, out = self._record(body, static, generators)
        launches = tuple((f, f.launches - n) for f, n in zip(COUNTED, counts)
                         if f.launches != n)
        for f, n in launches:
            f.launches -= n
        single = torch.is_tensor(out)
        outputs = tuple(t.detach() for t in ((out,) if single else out))
        return _Graph(graph, static, outputs, single, launches)

    def _record(self, body: Callable, static: Tuple[torch.Tensor, ...],
                generators: Sequence[torch.Generator]):
        """A new graph of ``body(*static)`` on the side stream, and the
        outputs it writes; it runs nothing."""
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        with torch.cuda.graph(graph, stream=self._side_stream(),
                              capture_error_mode="thread_local"):
            out = body(*static)
        return graph, out
