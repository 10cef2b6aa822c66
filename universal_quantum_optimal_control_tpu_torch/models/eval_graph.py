r"""The pulse models' eval forward as one CUDA graph a shape.

The counterpart of the training step's graph (``training/trainer.py``,
:meth:`~..training.trainer.Trainer.train_step`) for inference: on a card,
a forward in eval mode without autograd is captured once for each input
key and then replayed, so the host issues one launch where the eager
B = 1 forward issues some hundreds.  The graph holds the very kernels of
the eager forward (the same casts, LayerNorm statistics and head), so a
replay gives the eager forward's numbers.

A call takes the graph only where all of these hold: the parameters and
the input are on one card, the module is in eval mode, autograd, anomaly
mode and autocast are off, the current stream is not capturing (the
trainer's own capture runs the forward with autograd on) and no dropout
generator is passed.  Every other call runs eagerly, as the forward
always did.

The graphs are kept by the input's shape, dtype and device, by whether
inference mode is on and by the ``base`` tensor's storage (the
``length_400`` blend's base pulse, read in place); all of them read the
parameters and buffers where they lie, so ``load_state_dict``, which
copies into the same storage, keeps them, and a parameter or buffer given
new storage drops them all.  The first call of a key runs eagerly on a
side stream (the warm-up: cuBLAS's handle and workspace for that stream),
the second captures and replays, every later one copies its input into
the graph's, replays and returns a copy of the graph's output, which the
next replay rewrites.  At most ``EvalGraphs.limit`` keys are kept, the
least recently used dropped first.  A lock serialises the graph path, since a
served model may be called from several threads.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Any, Callable, Optional

import torch
from torch import nn

from ..utils.tracing import span

__all__ = ["EvalGraphs"]


@dataclasses.dataclass(frozen=True)
class _Graph:
    """One captured forward: the graph, the static input it reads and the
    static output it writes."""

    graph: Any
    x: torch.Tensor
    out: torch.Tensor

    def run(self, x: torch.Tensor) -> torch.Tensor:
        self.x.copy_(x)
        self.graph.replay()
        return self.out.clone()


class EvalGraphs:
    """The CUDA graphs of one module's eval forward (see the module's
    docstring).  Call it from the module's ``forward`` as
    ``graphs(module, forward, x, base, generator)``, where
    ``forward(x, base, generator)`` is the eager forward; the module holds
    the counters ``graph_captures`` and ``graph_replays``."""

    limit = 8     # input keys kept: eval CLIs that sweep batch sizes keep a few pools

    def __init__(self) -> None:
        self._graphs: "OrderedDict[tuple, Optional[_Graph]]" = OrderedDict()
        self._storage: Optional[tuple] = None    # the storage the graphs read
        self._side: Optional[torch.cuda.Stream] = None
        self._lock = threading.Lock()

    def __reduce__(self):
        # a copy or a pickle of the module starts with no graphs
        return EvalGraphs, ()

    @staticmethod
    def on_card(module: nn.Module, x: torch.Tensor) -> bool:
        """Whether ``x`` and the parameters lie on one card."""
        p = next(module.parameters(), None)
        return p is not None and x.is_cuda and p.device == x.device

    def graphable(self, module: nn.Module, x: torch.Tensor, generator) -> bool:
        """Whether the call ``module(x)`` takes the graph."""
        return (generator is None and not module.training and not torch.is_grad_enabled()
                and self.on_card(module, x) and not torch.is_anomaly_enabled()
                and not torch.is_autocast_enabled("cuda")
                and not torch.cuda.is_current_stream_capturing())

    @staticmethod
    def storage(module: nn.Module) -> tuple:
        """The addresses of the parameters and buffers that a graph reads,
        read from the modules' own tables (``module.parameters()`` takes
        several times as long, on every call)."""
        ptrs, stack = [], [module]
        while stack:
            m = stack.pop()
            ptrs += [t.data_ptr() for t in (*m._parameters.values(), *m._buffers.values())
                     if t is not None]
            stack += [c for c in m._modules.values() if c is not None]
        return tuple(ptrs)

    @staticmethod
    def key(x: torch.Tensor, base: Optional[torch.Tensor]) -> tuple:
        """The graph's key of input ``x`` with ``base``."""
        return (tuple(x.shape), x.dtype, x.device, torch.is_inference_mode_enabled(),
                None if base is None else (base.data_ptr(), tuple(base.shape),
                                           tuple(base.stride()), base.dtype))

    def __call__(self, module: nn.Module, forward: Callable, x: torch.Tensor,
                 base: Optional[torch.Tensor] = None, generator=None) -> torch.Tensor:
        if not self.graphable(module, x, generator):
            return forward(x, base, generator)
        with self._lock, torch.cuda.device(x.device):
            storage = self.storage(module)
            if storage != self._storage:
                self._graphs.clear()
                self._storage, self._side = storage, None
            key = self.key(x, base)
            if key not in self._graphs:
                out = self._warm_up(forward, x, base)
                self._graphs[key] = None
                if len(self._graphs) > self.limit:
                    self._graphs.popitem(last=False)
                return out
            self._graphs.move_to_end(key)
            graph = self._graphs[key]
            if graph is None:
                graph = self._graphs[key] = self._capture(forward, x, base)
                module.graph_captures += 1
                return graph.run(x)
            with span("model.graph_replay"):
                out = graph.run(x)
            module.graph_replays += 1
            return out

    def _side_stream(self) -> torch.cuda.Stream:
        if self._side is None:
            self._side = torch.cuda.Stream()
        return self._side

    def _warm_up(self, forward: Callable, x: torch.Tensor,
                 base: Optional[torch.Tensor]) -> torch.Tensor:
        """The eager forward on the stream that will capture."""
        current, side = torch.cuda.current_stream(), self._side_stream()
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = forward(x, base, None)
        current.wait_stream(side)
        return out

    def _capture(self, forward: Callable, x: torch.Tensor,
                 base: Optional[torch.Tensor]) -> _Graph:
        """Capture the forward on the side stream, reading a static input
        shaped as ``x``; it runs nothing (:meth:`_Graph.run` does).  Other
        threads may run CUDA work meanwhile: the capture refuses only this
        thread's unsafe calls."""
        static = torch.empty_like(x, memory_format=torch.contiguous_format)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self._side_stream(),
                              capture_error_mode="thread_local"):
            out = forward(static, base, None)
        return _Graph(graph, static, out)
