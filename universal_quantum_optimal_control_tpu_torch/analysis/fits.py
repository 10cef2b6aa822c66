r"""Continuous piecewise-linear least-squares fits (pwlf replacement): the
port's own copy of the JAX package's ``analysis/fits.py`` (pure numpy).

The reference fits robustness curves with the ``pwlf`` package
(visualize/util.py:336-357 — 2 segments on F(σ); :375-403 — 3 segments on
log-log infidelity).  pwlf is not available in this image; this module
implements the same model — continuous piecewise-linear with free interior
breakpoints — via a hinge basis ``(x − b)₊`` and an exhaustive/randomized
breakpoint search over the data grid.
"""

from __future__ import annotations

import itertools
from typing import Tuple

import numpy as np

__all__ = ["segmented_linear_fit", "piecewise_linear_eval"]


def _design(x: np.ndarray, breaks: Tuple[float, ...]) -> np.ndarray:
    cols = [np.ones_like(x), x]
    cols += [np.maximum(x - b, 0.0) for b in breaks]
    return np.stack(cols, axis=1)


def piecewise_linear_eval(x: np.ndarray, coef: np.ndarray,
                          breaks: Tuple[float, ...]) -> np.ndarray:
    return _design(np.asarray(x, float), breaks) @ coef


def segmented_linear_fit(
    x: np.ndarray,
    y: np.ndarray,
    n_segments: int = 2,
    max_candidates: int = 60,
    seed: int = 0,
) -> Tuple[np.ndarray, Tuple[float, ...], np.ndarray]:
    """Fit a continuous piecewise-linear curve with ``n_segments`` pieces.

    Breakpoints are searched over (subsampled) interior data sites; the
    best combination by SSE wins.  Returns ``(coef, breaks, y_hat)`` where
    ``coef = [intercept, slope, hinge₁, …]``.
    """
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    order = np.argsort(x)
    xs, ys = x[order], y[order]

    n_breaks = n_segments - 1
    if n_breaks == 0:
        A = _design(xs, ())
        coef, *_ = np.linalg.lstsq(A, ys, rcond=None)
        return coef, (), piecewise_linear_eval(x, coef, ())

    interior = xs[2:-2]
    if len(interior) > max_candidates:
        idx = np.linspace(0, len(interior) - 1, max_candidates).astype(int)
        interior = interior[idx]
    candidates = np.unique(interior)

    best = (np.inf, None, None)
    for combo in itertools.combinations(candidates, n_breaks):
        A = _design(xs, combo)
        coef, *_ = np.linalg.lstsq(A, ys, rcond=None)
        sse = float(np.sum((A @ coef - ys) ** 2))
        if sse < best[0]:
            best = (sse, coef, combo)
    _, coef, breaks = best
    return coef, tuple(breaks), piecewise_linear_eval(x, coef, breaks)
