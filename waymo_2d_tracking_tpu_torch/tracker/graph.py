"""The tracker step as a CUDA graph: the port's counterpart of
``jax.jit(track_step)`` and of the ``lax.scan`` over a chunk.

An eager ``track_step`` issues some 490 PyTorch ops from Python, and on the
card the host's time to issue them, not the device, sets the speed of the
tracker loop. A CUDA graph records one step's kernels once and replays them
with one call.

``StaticTrackerStep`` owns static buffers for one state (``[C,] S, ...``),
one frame of detections (``[C,] D, ...``) and one frame of outputs. Its
``body`` runs ``track_step`` on them and copies the new state back into the
state buffers and the outputs into the output buffers, so each run of the
body reads the previous frame's state. Run eagerly, as on the CPU, it is the
plumbing the graph replays.

``CapturedTracker`` is that body captured: warm-up steps on a side stream
(they build the kernels and make their one-time ``cudaFuncSetAttribute``
calls), then one step captured with ``torch.cuda.graph``. A replay adds to
the kernels' launch counters what the capture saw, with ``last_shape``, as
the eager launches would have. A capture or replay failure raises; nothing
carries on eagerly. Under a profiler each capture adds 1 to the counter
``graph_captures`` (``utils/profiling.py``), so that a graph rebuilt inside
a traced stretch shows.

``track_chunk`` is ``track_segment``'s contract for the drivers: a CUDA
state replays the driver's cached graph for its (config, shapes, dtypes,
device), a CPU state runs the eager ``track_segment``. Python branches of
``track_step`` on the config are fixed at capture, so the key holds the whole
``TrackerConfig``. A graph's buffers serve one caller at a time.

On the card a chunk's tracker work runs on a stream of its own (``Lane``:
one high-priority stream per graph cache and device, kept in the cache):
the detections' copies in, the replays and the copies into the output
stack. The chunk is latency-bound (the auction holds one warp a camera for
thousands of serial rounds), so the next chunk's staging and forward,
which the driver queues on its own stream meanwhile, fill the SMs it leaves
idle. Only the state threads from chunk to chunk, and it stays on the lane.
Before enqueuing, the lane waits on the caller's stream (the detections, a
fresh state), with no host synchronize; the caller's tensors get
``record_stream``; an event is recorded behind the chunk (``ChunkDone``).
The state and outputs ``track_chunk`` returns are ready once that event
has passed, so a consumer waits on it and never on the caller's stream:
``to_host`` copies a record on the lane's copy stream behind the event
alone (the chunked drivers' ``RollingFetch`` and final state), ``join``
makes the current stream wait on it (every other caller, at once). A graph
replayed on the lane runs at the lane's priority: CUDA launches a graph's
kernels at the priority of the stream it is launched into.

While tracing, ``track_chunk`` counts ``track_chunks`` (chunks tracked on
the lane) and ``track_overlapped`` (of them, those for which the cache's
previous chunk was still running when it was called: the chunk's own
staging and forward, queued before the call, then ran beside it); the
benchmark's ``track_overlap_share`` is their ratio.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from waymo_2d_tracking_tpu_torch.config import TrackerConfig
from waymo_2d_tracking_tpu_torch.ops.assign import auction_kernel_cuda
from waymo_2d_tracking_tpu_torch.ops.nms import nms_mask_cuda
from waymo_2d_tracking_tpu_torch.ops.roi_align import roi_align_cuda
from waymo_2d_tracking_tpu_torch.ops.topk import topk_threshold_cuda
from waymo_2d_tracking_tpu_torch.tracker.tracker import track_segment, track_step
from waymo_2d_tracking_tpu_torch.types import Detections, TrackerState, TrackOutputs
from waymo_2d_tracking_tpu_torch.utils.profiling import count, tracing

# the kernel wrappers whose launch counts a replay carries on
COUNTED = (nms_mask_cuda, auction_kernel_cuda, topk_threshold_cuda, roi_align_cuda)
WARMUP_STEPS = 3


def _fields(record):
    return [getattr(record, f.name) for f in dataclasses.fields(record)]


def _copy_into(dst, src) -> None:
    for d, s in zip(_fields(dst), _fields(src)):
        d.copy_(s)


def clone_record(record):
    """A copy of every field of a state / detections / outputs record."""
    return type(record)(**{f.name: getattr(record, f.name).clone()
                           for f in dataclasses.fields(record)})


def graph_key(cfg: TrackerConfig, state: TrackerState, det: Detections) -> Tuple:
    """What a captured step is specialised to: the whole config, every
    field's shape and dtype, the device."""
    return (cfg, tuple((tuple(t.shape), t.dtype) for t in _fields(state) + _fields(det)),
            state.mean.device)


class StaticTrackerStep:
    """One tracker step over static buffers (see the module docstring).

    ``state``: a template state, ``det``: one frame of detections; their
    shapes, dtypes and device fix the buffers. The state buffers start as a
    copy of ``state``.
    """

    def __init__(self, cfg: TrackerConfig, state: TrackerState, det: Detections):
        self.cfg = cfg
        self.state = clone_record(state)
        self.det = clone_record(det)
        s, dev = state.track_id.shape, state.mean.device
        self.out = TrackOutputs(
            track_id=torch.empty(s, dtype=state.track_id.dtype, device=dev),
            boxes=torch.empty(s + (4,), dtype=state.mean.dtype, device=dev),
            scores=torch.empty(s, dtype=state.score.dtype, device=dev),
            classes=torch.empty(s, dtype=state.classes.dtype, device=dev),
            valid=torch.empty(s, dtype=torch.bool, device=dev),
        )

    def body(self) -> None:
        """``track_step`` on the buffers; the new state and the frame's
        outputs are copied back into them."""
        new, out = track_step(self.state, self.det, self.cfg)
        _copy_into(self.state, new)
        _copy_into(self.out, out)

    def replay(self) -> None:
        self.body()

    def load_state(self, state: TrackerState) -> None:
        """Write ``state`` into the state buffers."""
        _copy_into(self.state, state)

    def current_state(self) -> TrackerState:
        """A copy of the state buffers: the next step overwrites them."""
        return clone_record(self.state)

    def step(self, det: Detections) -> TrackOutputs:
        """Advance the buffered state by one frame. Returns the output
        buffers, which the next step overwrites."""
        _copy_into(self.det, det)
        self.replay()
        return self.out

    def run(self, state: TrackerState, det_seq: Detections) -> Tuple[TrackerState, TrackOutputs]:
        """``track_segment``'s contract: the state is copied in once, each
        frame's outputs into a (T, ...) stack; returns a copy of the final
        state and the stack."""
        self.load_state(state)
        t_total = det_seq.boxes.shape[0]
        stack = TrackOutputs(**{
            f.name: torch.empty((t_total,) + buf.shape, dtype=buf.dtype, device=buf.device)
            for f, buf in zip(dataclasses.fields(self.out), _fields(self.out))
        })
        for t in range(t_total):
            out = self.step(det_seq[t])
            for dst, src in zip(_fields(stack), _fields(out)):
                dst[t].copy_(src)
        return self.current_state(), stack


class CapturedTracker(StaticTrackerStep):
    """``StaticTrackerStep`` whose body is a CUDA graph, replayed per frame.

    Raises on a CPU state: the graph exists only on the card."""

    def __init__(self, cfg: TrackerConfig, state: TrackerState, det: Detections):
        if state.mean.device.type != "cuda" or det.boxes.device != state.mean.device:
            raise ValueError("CapturedTracker takes a state and detections on one CUDA device")
        count("graph_captures", 1)
        super().__init__(cfg, state, det)
        side = torch.cuda.Stream(device=state.mean.device)
        side.wait_stream(torch.cuda.current_stream(state.mean.device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self.body()
        torch.cuda.current_stream(state.mean.device).wait_stream(side)

        before = [fn.launches for fn in COUNTED]
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: a prefetch worker may issue copies on its own stream
        # while the step is captured
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.body()
        # recorded, not launched: the counts go back, and each replay adds them
        self._launches = []
        for fn, n0 in zip(COUNTED, before):
            if fn.launches > n0:
                self._launches.append((fn, fn.launches - n0, fn.last_shape))
            fn.launches = n0
        self.load_state(state)

    def replay(self) -> None:
        self.graph.replay()
        for fn, n, shape in self._launches:
            fn.launches += n
            fn.last_shape = shape


@dataclasses.dataclass(frozen=True)
class ChunkDone:
    """The end of one chunk's tracker work on the card: ``event``, recorded
    on the lane behind the chunk, and ``copy``, the lane's stream for
    copies to the host."""

    event: torch.cuda.Event
    copy: torch.cuda.Stream


class Lane:
    """Where a graph cache's chunks run on one device: ``stream``, high
    priority, for the tracker's work; ``copy`` for copies to the host;
    ``done``, the ``ChunkDone`` of the last chunk (None before any)."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device=device, priority=-1)
        self.copy = torch.cuda.Stream(device=device)
        self.done: Optional[ChunkDone] = None


def _lane_key(device) -> Tuple:
    """The cache key of the lane on ``device``; ``cuda`` is the current
    card, as the tensors on it name it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return ("lane", device)


def chunk_done(graphs: Dict, device) -> Optional[ChunkDone]:
    """The ``ChunkDone`` of the last chunk ``track_chunk`` tracked with
    ``graphs`` on ``device``; None on the CPU or before any."""
    lane = graphs.get(_lane_key(device))
    return None if lane is None else lane.done


def to_host(record, done: Optional[ChunkDone]):
    """``record.to_numpy()`` once ``done`` has passed: copied on the lane's
    copy stream, which waits on that event alone, so nothing the caller
    queued since is drained. ``done`` None: on the current stream."""
    if done is None:
        return record.to_numpy()
    done.copy.wait_event(done.event)
    with torch.cuda.stream(done.copy):
        return record.to_numpy()


def join(graphs: Dict, device) -> None:
    """Make the current stream wait on the last chunk ``graphs`` tracked on
    ``device`` (no host synchronize): ``track_chunk``'s results are then
    ready for any work queued on it. Nothing on the CPU."""
    done = chunk_done(graphs, device)
    if done is not None:
        torch.cuda.current_stream(done.copy.device).wait_event(done.event)


def track_chunk(state: TrackerState, det_seq: Detections, cfg: TrackerConfig,
                graphs: Dict) -> Tuple[TrackerState, TrackOutputs]:
    """``track_segment``'s contract for a driver that owns ``graphs`` (a
    dict): on the card the captured step for this key, built at first use
    and kept there, replayed on the cache's lane (module docstring: read the
    results after ``to_host`` or ``join``); on the CPU the eager loop."""
    if state.mean.device.type != "cuda":
        return track_segment(state, det_seq, cfg)
    dev = state.mean.device
    lane = graphs.get(_lane_key(dev))
    if lane is None:
        lane = graphs[_lane_key(dev)] = Lane(dev)
    if tracing():
        count("track_chunks", 1)
        count("track_overlapped", int(lane.done is not None and not lane.done.event.query()))
    lane.stream.wait_stream(torch.cuda.current_stream(dev))
    for t in _fields(state) + _fields(det_seq):
        t.record_stream(lane.stream)
    with torch.cuda.stream(lane.stream):
        det = det_seq[0]
        key = graph_key(cfg, state, det)
        captured = graphs.get(key)
        if captured is None:
            captured = graphs[key] = CapturedTracker(cfg, state, det)
        result = captured.run(state, det_seq)
        event = torch.cuda.Event()
        event.record(lane.stream)
    lane.done = ChunkDone(event, lane.copy)
    return result
