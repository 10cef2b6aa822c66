r"""Named two-qubit benchmark gates (port of ``optimizers/two_qubit_grape.py``).

Only :func:`named_two_qubit_targets` is ported: the multi-start GRAPE
optimizer is ``ROADMAP.md`` A.16.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["named_two_qubit_targets"]


def named_two_qubit_targets() -> Dict[str, np.ndarray]:
    """The five named two-qubit gates (complex64 4×4), in the JAX package's
    order: CZ, ZZ(π/4), CNOT, iSWAP, √SWAP."""
    cz = np.diag([1, 1, 1, -1]).astype(np.complex64)
    zz = np.diag(np.exp(-1j * np.pi / 4 * np.array([1, -1, -1, 1]))).astype(np.complex64)
    cnot = np.array([[1, 0, 0, 0], [0, 1, 0, 0],
                     [0, 0, 0, 1], [0, 0, 1, 0]], np.complex64)
    iswap = np.array([[1, 0, 0, 0], [0, 0, 1j, 0],
                      [0, 1j, 0, 0], [0, 0, 0, 1]], np.complex64)
    sqrt_swap = np.array([[1, 0, 0, 0],
                          [0, 0.5 + 0.5j, 0.5 - 0.5j, 0],
                          [0, 0.5 - 0.5j, 0.5 + 0.5j, 0],
                          [0, 0, 0, 1]], np.complex64)
    return {"cz": cz, "zz(pi/4)": zz, "cnot": cnot, "iswap": iswap,
            "sqrt_swap": sqrt_swap}
