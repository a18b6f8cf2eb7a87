"""Tracing: the port's spans and counters behind one switch, and the Chrome
trace exporter (counterpart of ``utils/profiling.py``).

The switch is ``torch.profiler`` itself: ``tracing()`` is true while a
profiler records on the calling thread. With it on,

- ``span(name)`` is a ``record_function`` range ``w2t/<name>``: an event in
  the same trace, on the same clock, as the kernels it launches;
- ``count(name, n)`` adds ``n`` to a counter of the process's registry; a
  device tensor is added on its device, with no host synchronize, and read
  once by ``counters()``.

With it off, a span is one shared no-op context and a count adds nothing:
the cost is the flag's check (a fraction of a microsecond; a
``record_function`` costs some 13 microseconds even with no profiler). A
thread started inside ``profile()`` reads the flag as off, so a worker
thread hands what it measured to the driving thread, which counts it
(``data/prefetch.py``).

``trace(dir)`` wraps a region in a ``torch.profiler`` trace with CPU and,
where a card is present, CUDA activities; it empties the registry on entry
and writes, into ``dir``, the Chrome trace (the host's ops, the spans and
every device kernel, by name) and the counters beside it. It does nothing
when ``dir`` is empty.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Iterator, Optional

import torch

PREFIX = "w2t/"
_OFF = contextlib.nullcontext()
_counters: Dict[str, object] = {}


def tracing() -> bool:
    """True while a profiler records on the calling thread."""
    return torch._C._autograd._profiler_enabled()


def span(name: str):
    """``record_function("w2t/" + name)`` while tracing, else a no-op."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return _OFF


def count(name: str, n) -> None:
    """Add ``n`` (a number, or a tensor added where it lives) to counter
    ``name`` while tracing is on on the calling thread."""
    if torch._C._autograd._profiler_enabled():
        _counters[name] = _counters.get(name, 0) + n


def counters() -> Dict[str, float]:
    """The counters as plain numbers: device tensors read with one
    synchronize a device; integer counts stay ints."""
    items = dict(_counters)
    out = {k: v for k, v in items.items() if not isinstance(v, torch.Tensor)}
    by_device: Dict[torch.device, list] = {}
    for k, v in items.items():
        if isinstance(v, torch.Tensor):
            by_device.setdefault(v.device, []).append((k, v))
    for kv in by_device.values():
        values = torch.stack([v.detach().reshape(()).to(torch.float64) for _, v in kv]).tolist()
        for (k, v), x in zip(kv, values):
            out[k] = x if v.is_floating_point() else int(x)
    return out


def reset_counters() -> None:
    _counters.clear()


@contextlib.contextmanager
def trace(trace_dir: Optional[str]) -> Iterator[None]:
    """``torch.profiler`` trace of the region into ``trace_dir`` (a Chrome
    trace ``trace-<pid>-<ms>.json`` and its counters ``counters-<pid>-<ms>.json``),
    or a no-op when it is empty."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    reset_counters()
    with profile(activities=activities) as prof:
        yield
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    stamp = f"{os.getpid()}-{int(time.time() * 1e3)}"
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace-{stamp}.json"))
    with open(os.path.join(trace_dir, f"counters-{stamp}.json"), "w") as f:
        json.dump(counters(), f, sort_keys=True)
