r"""Structured training metrics — CSV writer + in-memory history (the port's
own copy of ``training/metrics.py``).

One row per epoch (band, σ_δ, σ_ε, epoch, loss, E[F], best E[F],
throughput), echoed as ``key=value`` lines and written as CSV on close.
"""

from __future__ import annotations

import csv
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

__all__ = ["MetricsLogger"]


class MetricsLogger:
    """Append-only metrics log.  Rows are dicts; the union of keys becomes the
    CSV header (written on close/flush)."""

    def __init__(self, path: Optional[str] = None, echo: bool = False) -> None:
        self.path = Path(path) if path is not None else None
        self.rows: List[Dict[str, Any]] = []
        self.echo = echo
        self._t0 = time.perf_counter()

    def log(self, **kwargs: Any) -> None:
        row = {"t_wall": round(time.perf_counter() - self._t0, 3), **kwargs}
        self.rows.append(row)
        if self.echo:
            print(" ".join(f"{k}={v}" for k, v in row.items()), flush=True)

    def flush(self) -> None:
        if self.path is None or not self.rows:
            return
        keys: List[str] = []
        for row in self.rows:
            for k in row:
                if k not in keys:
                    keys.append(k)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with open(self.path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=keys)
            writer.writeheader()
            writer.writerows(self.rows)

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.flush()
