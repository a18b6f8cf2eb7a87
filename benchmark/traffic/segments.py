"""Closed-loop segments: whole camera segments replayed back to back from the
bank, each under a context name of its own, through the program's offline
entry points: ``pipeline/run.py run_segments`` for one camera (prefetch, the copy,
downscale, letterbox, detect, the captured tracker, records, JSONL, gallery
sidecars and the manifest), ``pipeline/multicam.py run_segments_group`` for a
rig (a group of per-camera segments of one context).

The window is made of whole units: it starts at the first unit's call and
ends when the first unit to finish after ``--seconds`` returns. The rate is
the real camera-frames of the units done over the window's seconds.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np

from benchmark.harness.check import Sample, TrackUnit, check_cams as _check_cams, net_scale


def _chunks(ctx) -> int:
    return -(-ctx.traffic["frames"] // ctx.cfg["pipeline"]["chunk_frames"])


def plan(ctx):
    """Which units' detections feed the tracker check, and which of their
    chunks' head outputs the forward check, drawn from the seed among the
    first units every run reaches."""
    ctx.denom = ctx.cfg["pipeline"]["decode_scale_denom"]
    ctx.scale = net_scale(ctx.cfg, ctx.hw, ctx.denom)
    pool = ctx.cellf["trace_units"] if ctx.trace else ctx.cellf["check_pool"]
    ctx.check_units = sorted(ctx.rng.choice(pool, size=min(ctx.cellf["check_units"], pool),
                                            replace=False).tolist())
    ctx.head_chunks = {u: sorted(ctx.rng.choice(_chunks(ctx), size=min(
        ctx.cellf["check_chunks"], _chunks(ctx)), replace=False).tolist())
        for u in ctx.check_units}
    ctx.check_cams = _check_cams(ctx)
    return ([(u, c) for u in ctx.check_units for c in ctx.head_chunks[u]], ctx.check_units)


def _timestamps(ctx):
    return [k * ctx.traffic["timestamp_step_us"] for k in range(ctx.traffic["frames"])]


def _segments(ctx, unit: int, frames: int = None):
    from waymo_2d_tracking_tpu_torch.pipeline.run import SegmentFrames
    g = unit % ctx.cellf["bank_groups"]
    ts = _timestamps(ctx)[:frames]
    return [SegmentFrames(context_name=f"ctx{unit:05d}", camera_name=c + 1, timestamps=ts,
                          frames=ctx.bank_np[g, c, :frames]) for c in range(ctx.cams)]


def setup(ctx):
    from waymo_2d_tracking_tpu_torch.io_out import submission
    from waymo_2d_tracking_tpu_torch.pipeline import link, multicam, run as run_mod

    cfg = _port_cfg(ctx)
    p = ctx.probe
    if ctx.cams == 1:
        ctx.pipe = run_mod.SegmentPipeline(cfg, state_dict=ctx.state_dict, device=ctx.device)
        mod = run_mod
    else:
        ctx.pipe = multicam.MultiCamPipeline(cfg, num_cams=ctx.cams, state_dict=ctx.state_dict,
                                             device=ctx.device)
        mod = multicam
    p.wrap_detector(ctx.pipe.detector)
    for name in ("area_downscale", "letterbox_batch"):
        p.wrap(mod, name, "staging")
    p.wrap(mod, "track_chunk", "tracker")
    p.wrap(multicam if ctx.cams > 1 else link, "write_gallery_sidecar", "records")
    p.wrap(submission, "records_from_track_outputs", "records")
    p.wrap(submission, "write_jsonl", "records")
    # warm-up: one chunk of every shape the window runs (one chunk a unit)
    chunk = cfg.pipeline.chunk_frames
    p.begin(None)
    _drive(ctx, [_segments(ctx, 0, chunk)], os.path.join(ctx.out_dir, "warmup"))


def _port_cfg(ctx):
    from benchmark.harness.core import port_config
    return port_config(ctx.cfg)


def _drive(ctx, units, out_dir):
    """Run units (lists of per-camera segments) through the program; the
    probe learns each unit's index as it starts."""
    from waymo_2d_tracking_tpu_torch.pipeline.run import run_segments
    if ctx.cams == 1:
        run_segments(ctx.pipe, (segs[0] for segs in units), out_dir)
    else:
        os.makedirs(out_dir, exist_ok=True)
        for segs in units:
            ctx.pipe.run_segments_group(segs, out_dir)


def _units(ctx, stop):
    """Units 0, 1, ... while ``stop(k)`` is false; tells the probe and keeps
    each unit's seconds."""
    k = 0
    ctx.unit_s = []
    while not stop(k):
        ctx.probe.begin(k)
        t = time.perf_counter()
        yield _segments(ctx, k)
        ctx.unit_s.append(time.perf_counter() - t)
        k += 1
        ctx.units_done = k


def window(ctx):
    ctx.units_done = 0
    out = os.path.join(ctx.out_dir, "window")
    t0 = time.perf_counter()
    _drive(ctx, _units(ctx, lambda k: k > 0 and time.perf_counter() - t0 >= ctx.seconds), out)
    dt = time.perf_counter() - t0
    cam_frames = ctx.units_done * ctx.cams * ctx.traffic["frames"]
    ctx.window_dir = out
    u = np.array(ctx.unit_s)
    rec = np.array([ctx.probe.host_s[(k, "records")] for k in range(len(u))])
    from benchmark.harness.core import log
    log(f"window: {ctx.units_done} units in {dt:.3f} s, a unit's seconds min {u.min():.3f}, "
        f"median {np.median(u):.3f}, max {u.max():.3f}; by thirds "
        + ", ".join(f"{x.mean():.3f}" for x in np.array_split(u, 3) if x.size)
        + ", of them records (host) "
        + ", ".join(f"{x.mean():.3f}" for x in np.array_split(rec, 3) if x.size))
    log("window: each unit's seconds " + " ".join(f"{x:.3f}" for x in u)
        + "; records " + " ".join(f"{x:.3f}" for x in rec))
    return {"attempted": ctx.units_done, "failed": 0,
            "metrics": {"cam_frames_per_s": cam_frames / dt}, "seconds": dt}


def stretch(ctx):
    ctx.units_done = 0
    out = os.path.join(ctx.out_dir, "window")
    n = ctx.cellf["trace_units"]
    _drive(ctx, _units(ctx, lambda k: k >= n), out)
    ctx.window_dir = out
    return {"attempted": ctx.units_done, "failed": 0,
            "cam_frames": ctx.units_done * ctx.cams * ctx.traffic["frames"]}


def close(ctx):
    ctx.pipe = None


def artifacts(ctx):
    """The checked units' detections and records as the program left them."""
    chunk = ctx.cfg["pipeline"]["chunk_frames"]
    frames, cams = ctx.traffic["frames"], ctx.cams
    ts = _timestamps(ctx)
    samples, tracks = [], []
    for u in ctx.check_units:
        g = u % ctx.cellf["bank_groups"]
        dets = ctx.probe.dets.get(u) or [None] * _chunks(ctx)

        def batch(i, g=g):
            idx = np.minimum(np.arange(i * chunk, (i + 1) * chunk), frames - 1)
            return ctx.bank[g][:, idx].transpose(0, 1).reshape((-1,) + ctx.bank.shape[3:])

        for c in ctx.head_chunks[u]:
            samples.append(Sample((u, c), lambda c=c, b=batch: b(c), ctx.probe.heads.get((u, c)),
                                  dets[c] if c < len(dets) else None, ctx.denom))
        ctxname = f"ctx{u:05d}"
        rows, sidecars = [], []
        for c in range(cams):
            path = os.path.join(getattr(ctx, "window_dir", ""), f"{ctxname}_{c + 1}.jsonl")
            if os.path.exists(path):
                with open(path) as f:
                    rows += [_row(json.loads(line)) for line in f if line.strip()]
            side = path[:-len(".jsonl")] + ".gallery.npz"
            sidecars.append(dict(np.load(side)) if os.path.exists(side) else None)
        tracks.append(TrackUnit(u, dets, None if cams == 1 else cams, frames,
                                [ctxname] * cams, list(range(1, cams + 1)), ts, rows,
                                sidecars, ctx.scale, frames=batch, denom=ctx.denom,
                                check_cams=ctx.check_cams))
    return samples, tracks


def _row(r: dict):
    return (r["context_name"], r["timestamp_micros"], r["camera_name"], r["object_id"],
            r["object_type"], r["center_x"], r["center_y"], r["length"], r["width"], r["score"])
