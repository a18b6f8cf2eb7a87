"""Tracing and phase timing (counterpart of ``utils/profiling.py``).

``trace(dir)`` wraps a region in a ``torch.profiler`` trace with CPU and,
where a card is present, CUDA activities, and writes a Chrome trace (the
host's ops and every device kernel, by name) into ``dir``; it does nothing
when ``dir`` is empty. ``PhaseTimer`` accumulates host wall-clock per named
phase.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional


@contextlib.contextmanager
def trace(trace_dir: Optional[str]) -> Iterator[None]:
    """``torch.profiler`` trace of the region into ``trace_dir`` (a Chrome
    trace ``trace-<pid>-<time>.json``), or a no-op when it is empty."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"trace-{os.getpid()}-{int(time.time() * 1e3)}.json"))


class PhaseTimer:
    """Accumulates host wall-clock per named phase."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> Dict[str, dict]:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "calls": self.counts[name],
                "mean_ms": round(1000 * self.totals[name] / max(self.counts[name], 1), 3),
            }
            for name in self.totals
        }

    def dump(self) -> str:
        return json.dumps(self.report(), sort_keys=True)
