"""Run-time wrappers around the program's layer entry points.

While a run is traced, each wrapped entry point runs inside a
``record_function`` range named ``bench/<layer>``; the trace reader
(``trace.py``) gives each device operation the layer of the range that
launched it. Whether traced or not, the detector's wrappers keep copies of
what the timed path produced for the units the check samples: the head
outputs of sampled chunks, and the detections of every chunk of the units
whose track records are checked. The copies stay on the device until the
window has closed.
"""
from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict

import torch

DET_FIELDS = ("boxes", "scores", "classes", "embeds", "valid")


class Probe:
    def __init__(self, tracing: bool, want_heads=(), want_dets=()):
        self.tracing = tracing
        self.want_heads = set(want_heads)      # {(unit, chunk)}
        self.want_dets = set(want_dets)        # {unit}
        self.heads = {}
        self.dets = defaultdict(list)
        self.unit = None
        self.chunk = -1
        self.host_s = defaultdict(float)       # {(unit, layer)}: host seconds in wrapped calls
        self._restore = []

    def begin(self, unit) -> None:
        """The runner starts unit ``unit`` (a segment, a group or a tick)."""
        self.unit, self.chunk = unit, -1

    def range(self, name: str):
        return torch.profiler.record_function("bench/" + name) if self.tracing \
            else contextlib.nullcontext()

    def wrap(self, owner, attr: str, layer: str) -> None:
        """Replace ``owner.attr`` (a module's function or an object's
        method) by itself inside the layer's range, counting its host
        seconds to the unit."""
        fn = getattr(owner, attr)

        @functools.wraps(fn)
        def ranged(*a, **kw):
            t = time.perf_counter()
            try:
                with self.range(layer):
                    return fn(*a, **kw)
            finally:
                self.host_s[(self.unit, layer)] += time.perf_counter() - t

        self._set(owner, attr, ranged)

    def wrap_detector(self, runner) -> None:
        """The runner's ``forward`` and ``postprocess`` (what ``detect``
        calls) inside the ``detector`` range, keeping the sampled copies."""
        fwd, post = runner.forward, runner.postprocess

        def forward(images):
            self.chunk += 1
            with self.range("detector"):
                out = fwd(images)
            if (self.unit, self.chunk) in self.want_heads:
                self.heads[(self.unit, self.chunk)] = {
                    lvl: tuple(t.detach().clone() for t in v) for lvl, v in out[0].items()}
            return out

        def postprocess(head_out, feats):
            with self.range("detector"):
                dets = post(head_out, feats)
            if self.unit in self.want_dets:
                self.dets[self.unit].append({f: getattr(dets, f).detach().clone()
                                             for f in DET_FIELDS})
            return dets

        self._set(runner, "forward", forward)
        self._set(runner, "postprocess", postprocess)

    def _set(self, owner, attr, value) -> None:
        had = attr in getattr(owner, "__dict__", {})
        old = getattr(owner, attr)
        self._restore.append((owner, attr, old if had else None, had))
        setattr(owner, attr, value)

    def remove(self) -> None:
        for owner, attr, old, had in reversed(self._restore):
            if had:
                setattr(owner, attr, old)
            else:
                delattr(owner, attr)
        self._restore = []
