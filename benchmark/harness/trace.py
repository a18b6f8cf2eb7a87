"""Reading a ``torch.profiler`` trace: device intervals, the layer each
device operation belongs to, the busy share and the idle gaps.

A layer is a ``record_function`` range whose name starts with ``bench/``,
opened by the benchmark around the program's entry points (``wrap.py``).
A kernel belongs to the innermost such range around the runtime call that
launched it (matched by the profiler's correlation id; a CUDA graph's
kernels carry the correlation of its launch). Host -> device copies belong
to staging wherever they were issued (the prefetch worker's thread has no
range).
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

PREFIX = "bench/"
FRAMES = ("stretch", "tick")    # ranges that frame the work, not layers
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def export_events(prof) -> List[dict]:
    """The profiler's chrome-trace events (written to a temporary file under
    TMPDIR, read back and deleted)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def union_length(spans: List[Tuple[float, float]]) -> float:
    """Total length covered by the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(spans, lo: float, hi: float):
    return [(max(s, lo), min(e, hi)) for s, e in spans if e > lo and s < hi]


class Trace:
    """Events of one traced stretch, times in microseconds.

    ``device``: [(start, end, name, layer, kind)] with kind ``kernel``,
    ``h2d``, ``d2h`` or ``copy``; ``ranges``: {name: [(start, end)]} of the
    benchmark's ranges; ``window``: (start, end) of ``bench/stretch``."""

    def __init__(self, events: List[dict]):
        runtime: Dict[int, Tuple[float, int]] = {}
        ann: Dict[int, List[Tuple[float, float, str]]] = defaultdict(list)
        host_ops: Dict[int, List[Tuple[float, float, str]]] = defaultdict(list)
        raw_device = []
        self.ranges: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts, dur = e.get("cat", ""), float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            tid = e.get("tid")
            if cat in DEVICE_CATS:
                raw_device.append((ts, ts + dur, e.get("name", ""), cat,
                                   (e.get("args") or {}).get("correlation")))
            elif cat in ("cuda_runtime", "cuda_driver"):
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    runtime[corr] = (ts, tid)
                host_ops[tid].append((ts, ts + dur, e.get("name", "")))
            elif cat == "user_annotation":
                name = e.get("name", "")
                if name.startswith(PREFIX):
                    ann[tid].append((ts, ts + dur, name[len(PREFIX):]))
                    self.ranges[name[len(PREFIX):]].append((ts, ts + dur))
                host_ops[tid].append((ts, ts + dur, name))
            elif cat == "cpu_op":
                host_ops[tid].append((ts, ts + dur, e.get("name", "")))
        for lst in ann.values():
            lst.sort()
        layer_ann = {tid: [a for a in lst if a[2] not in FRAMES] for tid, lst in ann.items()}
        self.device = []
        for s, t, name, cat, corr in raw_device:
            kind = "kernel"
            if cat == "gpu_memcpy":
                kind = "h2d" if "HtoD" in name else "d2h" if "DtoH" in name else "copy"
            layer = "staging" if kind == "h2d" else None
            if layer is None and corr in runtime:
                layer = _innermost(layer_ann.get(runtime[corr][1], []), runtime[corr][0])
            self.device.append((s, t, name, layer or "other", kind))
        self.host_ops = host_ops
        self.ann = ann
        win = self.ranges.get("stretch")
        self.window = win[0] if win else (
            min((d[0] for d in self.device), default=0.0),
            max((d[1] for d in self.device), default=0.0))
        self.main_tid = None
        for tid, lst in ann.items():
            if any(n == "stretch" for _, _, n in lst):
                self.main_tid = tid

    # ---------------------------------------------------------------- reads
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_spans(self, lo: Optional[float] = None, hi: Optional[float] = None):
        lo = self.window[0] if lo is None else lo
        hi = self.window[1] if hi is None else hi
        return merged(clip([(d[0], d[1]) for d in self.device], lo, hi))

    def busy_s(self, lo=None, hi=None) -> float:
        return sum(e - s for s, e in self.busy_spans(lo, hi)) * 1e-6

    def layer_s(self, layer: str, name_has: Optional[str] = None) -> float:
        """Device seconds of a layer's operations inside the window (their
        own union, so overlapping streams count once)."""
        spans = [(d[0], d[1]) for d in self.device if d[3] == layer
                 and (name_has is None or name_has in d[2])]
        return union_length(clip(spans, *self.window)) * 1e-6

    def kernels(self, name_has: str) -> List[Tuple[float, float, str]]:
        lo, hi = self.window
        return [(d[0], d[1], d[2]) for d in self.device
                if d[4] == "kernel" and name_has in d[2] and d[1] > lo and d[0] < hi]

    def top_ops(self, n: int = 10):
        by: Dict[str, float] = defaultdict(float)
        for s, e, name, _, _ in self.device:
            s, e = max(s, self.window[0]), min(e, self.window[1])
            if e > s:
                by[name[:120]] += (e - s) * 1e-6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10):
        """The n longest stretches with nothing on the device, each named by
        the innermost host operation or range on the driving thread at its
        middle."""
        lo, hi = self.window
        busy = self.busy_spans()
        gaps, cur = [], lo
        for s, e in busy:
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if hi > cur:
            gaps.append((cur, hi))
        gaps.sort(key=lambda g: -(g[1] - g[0]))
        ops = sorted(self.host_ops.get(self.main_tid, []))
        out = []
        for s, e in gaps[:n]:
            mid = (s + e) / 2
            name = (_innermost(ops, mid) or _innermost(self.ann.get(self.main_tid, []), mid)
                    or "host, outside any traced op")
            out.append([name[:120], (e - s) * 1e-6])
        return out


def _innermost(spans: List[Tuple[float, float, str]], t: float) -> Optional[str]:
    """Name of the latest-starting span (sorted by start) that contains t."""
    i = bisect.bisect_right(spans, (t, float("inf"), "￿"))
    best = None
    for s, e, name in reversed(spans[max(0, i - 4096):i]):
        if s <= t <= e:
            best = name
            break
    return best
