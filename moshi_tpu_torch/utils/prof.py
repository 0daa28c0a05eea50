"""Per-frame latency metrics and named profiling scopes.

Counterpart of ``moshi_tpu/utils/prof.py``: ``FrameTimer`` collects
per-frame wall-clock latencies and reports percentiles against the 80 ms
real-time budget; ``scope(name)`` names a region in ``torch.profiler``
traces (``torch.profiler.record_function``).  The caller syncs inside
``frame()``, as in the JAX package, by fetching the frame's output to the
host: a timer around launches alone measures the host's queueing.
"""

from __future__ import annotations

import contextlib
import time
from typing import List

import numpy as np
import torch


def scope(name: str):
    """A named region in torch.profiler traces."""
    return torch.profiler.record_function(name)


class FrameTimer:
    """Per-frame wall-clock latencies and their percentiles against the
    80 ms real-time budget."""

    def __init__(self, budget_ms: float = 80.0):
        self.budget_ms = budget_ms
        self.samples: List[float] = []

    @contextlib.contextmanager
    def frame(self):
        t0 = time.perf_counter()
        yield
        self.samples.append((time.perf_counter() - t0) * 1000)

    def percentile(self, p: float) -> float:
        return float(np.percentile(self.samples, p)) if self.samples else 0.0

    def fps(self) -> float:
        total = sum(self.samples) / 1000
        return len(self.samples) / total if total else 0.0

    def report(self) -> dict:
        return {
            "frames": len(self.samples),
            "fps": round(self.fps(), 2),
            "p50_ms": round(self.percentile(50), 2),
            "p95_ms": round(self.percentile(95), 2),
            "p99_ms": round(self.percentile(99), 2),
            "over_budget": int(sum(s > self.budget_ms for s in self.samples)),
            "realtime": self.percentile(50) <= self.budget_ms,
        }
