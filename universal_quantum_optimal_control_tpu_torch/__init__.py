"""universal_quantum_optimal_control_tpu_torch — the PyTorch/CUDA port.

The serving path of the universal SU(2) pulse model (rotation vector →
pulse table → robustness score) on an NVIDIA H100, beside the JAX package
``universal_quantum_optimal_control_tpu``, which stays the reference.  The
port imports ``torch`` and ``numpy`` only: nothing of JAX and nothing of
the JAX package (it keeps its own copies of the helpers it needs).

Layout mirrors the JAX package — ``core/`` (quaternion algebra, disorder,
plain propagators), ``ops/`` (the hand-written CUDA kernels and their
wrappers), ``parallel/``, ``models/``, ``data/``, ``demo/``, ``analysis/``
and ``utils/``.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
