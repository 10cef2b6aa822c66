r"""Analytic SCORE composite-pulse baselines: the port's own copy of the JAX
package's ``analysis/score_pulses.py`` (pure numpy).

Reimplements the reference's SCORE pulse table and discretizer
(visualize/util.py:42-146): published SCORE-n angle vectors for
n ∈ {¼, ⅓, ½, ⅔, ¾, 1}, the 9-pulse palindromic composite construction, its
~400-slice equal-dt discretization, and the named composite targets
(X(π), X(π/2), Hadamard, Z(π/4)) built as products of SCORE pulses.

These analytic pulses are the known-good robustness baseline the learned
models are compared against (train/README.md "compared to the SCORE4 pulse").

Convention note: a pulse row is ``(φ, τ)`` with τ equal to the zero-disorder
rotation angle (H carries the ½ — ``core/su2.py::segment_quat``), which matches both
the reference's training propagator (SCORE.py:124-127) and its visualizer's
τ/2 half-angle step (visualize_universal_with_pipeline.py:34) — they are the
same convention expressed at different levels; there is exactly one
propagator here.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["SCORE_ANGLE_VECTORS", "NAMED_SCORE_TARGETS", "score_n_config",
           "build_score_pulses"]

# Published SCORE-n flanking-angle vectors (units of pi) —
# reference visualize/util.py:47-54.
SCORE_ANGLE_VECTORS: Dict[float, List[float]] = {
    1 / 4: [1.34820, 1.32669, 1.77042, 2.16800],
    1 / 3: [1.41901, 1.35864, 1.77664, 2.13759],
    1 / 2: [1.55280, 1.42267, 1.78586, 2.07559],
    2 / 3: [1.67478, 1.47865, 1.78919, 2.02043],
    3 / 4: [1.73053, 1.49972, 1.78853, 1.99939],
    1: [1.87342, 1.52524, 1.78436, 1.97330],
}

# Named gates as sequences of (n, phi/pi) SCORE pulses, applied right-to-left
# (reference visualize/util.py:56-61).
NAMED_SCORE_TARGETS: Dict[str, List[Tuple[float, float]]] = {
    "X(pi)": [(1, 0)],
    "X(pi/2)": [(1 / 2, 0)],
    "Hadamard": [(1, 0), (1 / 2, 1 / 2)],
    "Z(pi/4)": [(1, 0), (1 / 2, 1 / 2), (1 / 4, 0), (1, 0), (1 / 2, 1 / 2)],
}


def score_n_config(n: float, phi: float, n_slices: int = 400) -> np.ndarray:
    """Discretized 9-pulse palindromic SCORE-n sequence about in-plane φ.

    Construction (reference util.py:64-112): four flanking pulses with
    alternating axis φ/φ+π and published angles aᵢ·π, a middle pulse whose
    angle closes the composite to a net rotation of n·π, mirrored flanks; the
    whole sequence is re-sliced into ~``n_slices`` equal-duration segments.

    Returns ``(S, 2)`` float32 rows ``(φᵢ, τᵢ)``.
    """
    angle_vec = SCORE_ANGLE_VECTORS[n]
    config: List[Tuple[float, float]] = []
    net = math.pi * n
    for i, a in enumerate(angle_vec):
        config.append((phi + (i % 2) * math.pi, a * math.pi))
        net += (-1) ** (len(angle_vec) - 1 - i) * 2 * a * math.pi
    config.append((phi, net))
    for i, a in reversed(list(enumerate(angle_vec))):
        config.append((phi + (i % 2) * math.pi, a * math.pi))

    total = sum(angle for _, angle in config)
    dt = total / n_slices
    rows: List[Tuple[float, float]] = []
    for p, angle in config:
        N = math.ceil(angle / dt)
        rows.extend([(p, angle / N)] * N)
    return np.asarray(rows, dtype=np.float32)


def build_score_pulses(
    targets: Dict[str, List[Tuple[float, float]]] = None,
    n_slices: int = 400,
    save_dir: str = None,
) -> Dict[str, np.ndarray]:
    """Build discretized SCORE pulse sequences for named composite targets
    (reference ``build_SCORE_pulses``, util.py:115-146).

    The per-target SCORE pulses compose right-to-left (reversed iteration,
    util.py:131).  Optionally exports one CSV per target.
    """
    targets = targets if targets is not None else NAMED_SCORE_TARGETS
    out: Dict[str, np.ndarray] = {}
    for name, spec in targets.items():
        blocks = [score_n_config(n, p * math.pi, n_slices)
                  for n, p in reversed(spec)]
        out[name] = np.concatenate(blocks, axis=0)

    if save_dir is not None:
        import csv
        import os

        os.makedirs(save_dir, exist_ok=True)
        for name, arr in out.items():
            safe = name.replace("/", "-")
            with open(os.path.join(save_dir, f"{safe}_SCORE_pulse.csv"),
                      "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["phi", "tau"])
                w.writerows(arr.tolist())
    return out
