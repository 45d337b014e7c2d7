"""Tracing & per-stage timing — a first-class module (SURVEY.md §5: the
reference has none; only an undefined calculateTime helper at
/root/reference/include/feature_detector.h:73).

- StageTimer: named wall-clock accumulators with device sync, for per-frame
  pipeline breakdowns (ingest / pyramid / select / track / ba).
- trace(): context manager around jax.profiler for device timeline capture.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax


class StageTimer:
    """Accumulates wall time per named stage; blocks on device results so device
    async dispatch doesn't misattribute time."""

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, *block_on):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync:
                for x in block_on:
                    jax.block_until_ready(x)
            dt = time.perf_counter() - t0
            self.total[name] += dt
            self.count[name] += 1

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            k: {
                "total_s": self.total[k],
                "count": self.count[k],
                "mean_ms": 1e3 * self.total[k] / max(self.count[k], 1),
            }
            for k in self.total
        }

    def report(self) -> str:
        rows = [
            f"{k:>12s}: {v['mean_ms']:8.2f} ms/call x{v['count']}"
            for k, v in sorted(self.summary().items())
        ]
        return "\n".join(rows)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace viewable in TensorBoard/XProf."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
