"""The open loop that offers requests at the rate the traffic fixes.

Request ``i`` is due at ``i / rate`` seconds into the window; every request
due inside the window is run, in order, one at a time, and its latency runs
from when it was due to when its answer is on the host, so a slow request
delays the ones behind it.  The requests whose answers are checked are
drawn from the seed among those due, before the window opens.
"""

from __future__ import annotations

import time
import traceback

import numpy as np

from port_bench.harness import Run, log

MISSING_MS = 1e9   # the latency a failed request is counted at: it never comes


def request_seed(base: int, i: int) -> int:
    """The seed of request ``i``'s own draws."""
    return (base + i * 0x9E3779B97F4A7C15) % (1 << 63)


def checked_requests(run: Run, n_due: int) -> set:
    rng = np.random.default_rng(run.seed % (1 << 64))
    return set(rng.choice(n_due, size=min(run.traffic["checked"], n_due),
                          replace=False).tolist())


def open_loop(run: Run, request, seconds: float) -> dict:
    """Run the requests due in ``seconds``; returns the window's counts, its
    latency percentiles, the mean service time and the kept answers."""
    rate = run.traffic["rate_per_s"]
    n_due = max(1, int(rate * seconds))
    checked = checked_requests(run, n_due)
    latency, service, late, kept, failed = [], [], [], {}, 0
    t0 = time.perf_counter()
    for i in range(n_due):
        due = t0 + i / rate
        now = time.perf_counter()
        if now < due:
            if due - now > 1e-3:
                time.sleep(due - now - 1e-3)
            while time.perf_counter() < due:
                pass
            late.append(time.perf_counter() - due)
        start = time.perf_counter()
        try:
            answer = request(i)
        except Exception:            # a failed request is counted, never retried
            failed += 1
            if failed == 1:
                log("request failed:\n" + traceback.format_exc())
            latency.append(MISSING_MS / 1e3)
            continue
        end = time.perf_counter()
        latency.append(end - due)
        service.append(end - start)
        if i in checked:
            kept[i] = answer
    run.state["next"] = n_due
    lat = np.asarray(latency) * 1e3
    if late:
        log(f"generator lateness when idle: median {np.median(late) * 1e6:.1f} us, "
            f"max {np.max(late) * 1e6:.1f} us over {len(late)} requests")
    log(f"service time: median {np.median(service) * 1e3:.4f} ms, "
        f"p95 {np.percentile(service, 95) * 1e3:.4f} ms")
    return {"attempted": n_due, "failed": failed,
            "metrics": {"request_p50_ms": float(np.percentile(lat, 50)),
                        "request_p95_ms": float(np.percentile(lat, 95))},
            "unit_s": float(np.mean(service)) if service else float("nan"),
            "kept": kept}
