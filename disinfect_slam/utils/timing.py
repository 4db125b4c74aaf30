"""Timing utilities (utils/time.hpp equivalents) and lightweight spans.

The reference instruments per-stage wall-clock ms and surfaces them in
UI overlays / spdlog lines (SURVEY.md §5).  Here the same counters feed
the CLI apps and bench harness; `trace_span` additionally hooks into
jax.profiler so device traces carry the stage names.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

import jax


def get_timestamp_ms() -> int:
    """Steady-clock milliseconds (GetTimestamp<std::chrono::milliseconds>,
    time.hpp:10-14)."""
    return time.monotonic_ns() // 1_000_000


def get_system_timestamp_ms() -> int:
    """System-clock milliseconds (GetSystemTimestamp, time.hpp:18-22)."""
    return time.time_ns() // 1_000_000


class LocalClock:
    """Offset converter between an external clock and the steady clock
    (time.hpp:24-33)."""

    def __init__(self, external_now_ms: int):
        self.offset = get_timestamp_ms() - external_now_ms

    def convert(self, external_ms: int) -> int:
        return external_ms + self.offset


class StageTimer:
    """Accumulates per-stage latencies; mirrors the reference's live
    'Integration takes %lu ms' style counters (offline.cc:168-198)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.last: Dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        with jax.profiler.TraceAnnotation(name):
            t0 = time.perf_counter()
            yield
            dt = time.perf_counter() - t0
        self.totals[name] += dt
        self.counts[name] += 1
        self.last[name] = dt

    def mean_ms(self, name: str) -> float:
        c = self.counts.get(name, 0)
        return 1e3 * self.totals[name] / c if c else 0.0

    def summary(self) -> Dict[str, float]:
        return {k: self.mean_ms(k) for k in self.totals}
