"""Host -> device prefetch of chunks (counterpart of ``data/prefetch.py``).

A worker thread takes the next host chunk from ``produce``, applies
``transform`` and copies it to ``device`` while the device computes on the
current one. The queue holds at most ``depth`` chunks, which bounds host
memory and how far the worker runs ahead.

On a CUDA device the copy is asynchronous and overlaps the compute stream:

- the worker copies each chunk into one of ``depth + 1`` pinned host
  buffers (a ring), and reuses a buffer only after the event recorded
  behind its last copy has completed;
- it issues the host -> device copy ``non_blocking`` on its own side stream
  and records an event behind it;
- the consumer makes its current stream wait on that event (no host
  synchronize) and calls ``record_stream`` on the chunk, so the caching
  allocator does not hand its memory to another tensor while the consumer's
  stream may still read it.

On the CPU the same class yields plain tensors, with no pinning and no
stream.

Chunks are numpy arrays; dicts of them (training batches), which arrive as
dicts of tensors; or a rig's chunk, a list or tuple of equal-shape
(chunk, H, W, 3) arrays, one a camera, which arrives as one
(chunk, cams, H, W, 3) tensor: the worker gathers each camera's block
straight into its place in the pinned buffer (on the CPU, into a fresh
tensor), with no stacked host array in between.

Tracing (``utils/profiling.py``): the consumer's wait for the next chunk is
the span ``w2t/prefetch_wait``; the counters ``prefetch_chunks`` (chunks
taken) and ``prefetch_ready`` (of them, those already queued when the
consumer asked) say how often the worker kept ahead. The worker times each
chunk's source, transform and copy and queues the seconds with the chunk;
the consumer adds them to the counter ``prefetch_fill_s`` (the worker's
thread reads no profiler).

Lifecycle: ``close()`` (or leaving the ``with`` block) unblocks and joins the
worker, which closes the source iterator in its own thread (running the
source generator's ``finally``). An exception in the worker or the source is
raised on the consumer's side.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from waymo_2d_tracking_tpu_torch import resolve_device
from waymo_2d_tracking_tpu_torch.utils.profiling import count, span

_SENTINEL = object()


class DevicePrefetcher:
    """Iterate host chunks; yield them on ``device``, copied ahead.

    produce: iterable of numpy arrays (e.g. repeat-padded uint8 frame chunks),
      of dicts of numpy arrays, or of lists of per-camera arrays (a rig).
    depth: chunks staged ahead (2 = double buffering).
    transform: optional host-side function applied in the worker thread
      before the copy.
    device: where chunks go, ``"cuda"`` by default; ``"cpu"`` yields plain
      CPU tensors.
    """

    def __init__(self, produce: Iterable, depth: int = 2,
                 transform: Optional[Callable] = None, device="cuda"):
        self.device = resolve_device(device)
        self._depth = max(int(depth), 1)
        self._queue: queue.Queue = queue.Queue(maxsize=self._depth)
        self._transform = transform
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self._stream = torch.cuda.Stream(device=self.device)
            # pinned ring: slot -> (buffer, event of its last copy)
            self._ring = [[None, None] for _ in range(self._depth + 1)]
            self._slot = 0
        self._thread = threading.Thread(target=self._worker, args=(iter(produce),),
                                        daemon=True)
        self._thread.start()

    def _to_device(self, item):
        """A numpy array, or a dict of them (a training batch), on the
        device; on the card (tensors, event behind their copies)."""
        if isinstance(item, (list, tuple)):
            return self._gather_to_device(item)
        arrays = item if isinstance(item, dict) else {None: item}
        host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()}
        if not self._cuda:
            return host if isinstance(item, dict) else host[None]
        slot = self._ring[self._slot]
        self._slot = (self._slot + 1) % len(self._ring)
        bufs, done = slot
        if done is not None:
            done.synchronize()          # its last copy has left the buffers
        bufs = dict(bufs or {})
        for k, h in host.items():
            buf = bufs.get(k)
            if buf is None or buf.shape != h.shape or buf.dtype != h.dtype:
                bufs[k] = torch.empty(h.shape, dtype=h.dtype, pin_memory=True)
            bufs[k].copy_(h)
        with torch.cuda.stream(self._stream):
            dev = {k: bufs[k].to(self.device, non_blocking=True) for k in host}
            ready = torch.cuda.Event()
            ready.record(self._stream)
        slot[0], slot[1] = bufs, ready
        return (dev if isinstance(item, dict) else dev[None]), ready

    def _gather_to_device(self, blocks):
        """A rig's chunk, equal-shape (chunk, H, W, 3) arrays one a camera,
        as one (chunk, cams, H, W, 3) tensor: each camera's block is copied
        straight into ``buf[:, i]`` of a pinned ring slot, then the slot
        crosses in one copy; on the CPU ``buf`` is a fresh tensor."""
        hws = {b.shape[1:3] for b in blocks}
        assert len(hws) == 1, (
            "multicam shared-backbone batch needs equal-resolution "
            f"cameras, got {sorted(hws)}; run mixed-resolution cameras "
            "as separate single-camera segments instead"
        )
        host = [torch.from_numpy(b) for b in blocks]
        shape = (host[0].shape[0], len(host)) + tuple(host[0].shape[1:])
        dtype = host[0].dtype
        if self._cuda:
            slot = self._ring[self._slot]
            self._slot = (self._slot + 1) % len(self._ring)
            bufs, done = slot
            if done is not None:
                done.synchronize()      # its last copy has left the buffer
            buf = (bufs or {}).get(None)
            if buf is None or buf.shape != shape or buf.dtype != dtype:
                buf = torch.empty(shape, dtype=dtype, pin_memory=True)
        else:
            buf = torch.empty(shape, dtype=dtype)
        for i, h in enumerate(host):
            buf[:, i].copy_(h)
        if not self._cuda:
            return buf
        with torch.cuda.stream(self._stream):
            dev = buf.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        slot[0], slot[1] = {None: buf}, ready
        return dev, ready

    def _worker(self, it: Iterator):
        try:
            while True:
                t0 = time.perf_counter()
                item = next(it, _SENTINEL)
                if item is _SENTINEL or self._stop.is_set():
                    return
                if self._transform is not None:
                    item = self._transform(item)
                item = self._to_device(item), time.perf_counter() - t0
                # a put that stays responsive to close(): a plain put()
                # would block forever once the consumer is gone
                while True:
                    try:
                        self._queue.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        if self._stop.is_set():
                            return
        except BaseException as e:  # noqa: BLE001 - raised on the consumer side
            self._error = e
        finally:
            # close the source in the only thread that iterates it
            close = getattr(it, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:  # noqa: BLE001 - the stream's error, if any, wins
                    pass
            # a slow consumer may leave the queue full: keep offering the
            # sentinel until it is taken or close() is called
            while True:
                try:
                    self._queue.put(_SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    if self._stop.is_set():
                        break

    def close(self) -> None:
        """Unblock and join the worker; idempotent."""
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __iter__(self):
        while True:
            with span("prefetch_wait"):
                try:
                    item, queued = self._queue.get_nowait(), 1
                except queue.Empty:
                    item, queued = self._queue.get(), 0
            if item is _SENTINEL:
                if self._error is not None:
                    raise self._error
                self._thread.join(timeout=10.0)
                return
            item, fill_s = item
            count("prefetch_fill_s", fill_s)
            count("prefetch_chunks", 1)
            count("prefetch_ready", queued)
            if self._cuda:
                item, ready = item
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(ready)
                for t in (item.values() if isinstance(item, dict) else (item,)):
                    t.record_stream(stream)
            yield item


def prefetch_to_device(iterable, depth: int = 2, transform=None, device="cuda"):
    """Functional form: ``for chunk in prefetch_to_device(chunks): ...``.

    It cannot release the worker if the consumer stops early; use ``with
    DevicePrefetcher(...) as pf: for chunk in pf`` wherever an exception can
    leave the loop (``pipeline/run.py`` does)."""
    return iter(DevicePrefetcher(iterable, depth=depth, transform=transform, device=device))
