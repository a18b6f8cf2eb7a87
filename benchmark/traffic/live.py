"""Open-loop live ticks: tick k of a rig (or of one camera) is due at
t0 + k / rate_hz and carries each camera's decoded frame from the bank; it
goes through the program's streaming session (``pipeline/online.py
OnlineMultiCamTracker.step``, or ``OnlineTracker.step`` for one camera),
which returns the tick's track records on the host. A tick's latency runs
from its due time to its records, so a tick that runs long delays the
ticks behind it. The session starts a fresh track table at each segment
boundary of the bank (``frames`` ticks)."""
from __future__ import annotations

import time

import numpy as np

from benchmark.harness.check import Sample, TrackUnit, check_cams as _check_cams, net_scale


def plan(ctx):
    """Segment 0's ticks feed the tracker check; a sample of them, drawn from
    the seed, the forward check. Decoded frames enter the session at their
    source size: no decode downscale."""
    ctx.denom = 1
    ctx.scale = net_scale(ctx.cfg, ctx.hw, 1)
    n = ctx.cellf["trace_units"] if ctx.trace else int(ctx.seconds * ctx.traffic["rate_hz"])
    ctx.n_ticks = max(n, 1)
    ctx.check_ticks = list(range(min(ctx.n_ticks, ctx.traffic["frames"])))
    ctx.head_ticks = sorted(ctx.rng.choice(ctx.check_ticks, size=min(
        ctx.cellf["check_chunks"], len(ctx.check_ticks)), replace=False).tolist())
    ctx.check_cams = _check_cams(ctx)
    return [(k, 0) for k in ctx.head_ticks], ctx.check_ticks


def setup(ctx):
    from benchmark.harness.core import port_config
    from waymo_2d_tracking_tpu_torch.pipeline import online

    from waymo_2d_tracking_tpu_torch.io_out import submission

    cfg = port_config(ctx.cfg)
    names = list(range(1, ctx.cams + 1))
    if ctx.cams == 1:
        ctx.sess = online.OnlineTracker(cfg, state_dict=ctx.state_dict, device=ctx.device,
                                        context_name="live", camera_name=1)
    else:
        ctx.sess = online.OnlineMultiCamTracker(cfg, names, state_dict=ctx.state_dict,
                                                device=ctx.device, context_name="live")
    ctx.sess.warmup(ctx.hw)
    p = ctx.probe
    p.wrap_detector(ctx.sess.detector)
    p.wrap(online, "letterbox_batch", "staging")
    p.wrap(ctx.sess, "_track", "tracker")
    p.wrap(submission, "records_from_track_outputs", "records")
    # one untimed tick of real frames, then a fresh table: the step the window runs
    p.begin(None)
    _step(ctx, 0)
    ctx.sess.reset()


def _step(ctx, k: int):
    f = k % ctx.traffic["frames"]
    frames = [ctx.bank_np[0, c, f] for c in range(ctx.cams)]
    ts = k * ctx.traffic["timestamp_step_us"]
    return ctx.sess.step(frames[0], ts) if ctx.cams == 1 else ctx.sess.step(frames, ts)


def _ticks(ctx, n: int, traced: bool):
    import torch
    period = 1.0 / ctx.traffic["rate_hz"]
    seg = ctx.traffic["frames"]
    due, start, done = np.zeros(n), np.zeros(n), np.zeros(n)
    ctx.rows = []
    ctx.tick_us = []
    t0 = time.perf_counter() + 0.01
    for k in range(n):
        due[k] = t0 + k * period
        wait = due[k] - time.perf_counter()
        if wait > 0.002:
            time.sleep(wait - 0.002)
        while time.perf_counter() < due[k]:
            pass
        ctx.probe.begin(k)
        rng = torch.profiler.record_function("bench/tick") if traced else None
        if rng is not None:
            rng.__enter__()
        start[k] = time.perf_counter()
        if k and k % seg == 0:
            ctx.sess.reset()
        recs = _step(ctx, k)
        done[k] = time.perf_counter()
        if rng is not None:
            rng.__exit__(None, None, None)
        if k < seg:
            ctx.rows += [(r.context_name, r.timestamp_micros, r.camera_name, r.object_id,
                          r.object_type, r.center_x, r.center_y, r.length, r.width, r.score)
                         for r in recs]
    return due, start, done, t0


def window(ctx):
    due, start, done, t0 = _ticks(ctx, ctx.n_ticks, False)
    lat = (done - due) * 1e3
    late = (start - due) * 1e3
    from benchmark.harness.core import log
    log(f"generator: {ctx.n_ticks} ticks at {ctx.traffic['rate_hz']} Hz; a tick started late "
        f"by p50 {np.percentile(late, 50):.3f} ms, p95 {np.percentile(late, 95):.3f} ms, "
        f"max {late.max():.3f} ms")
    return {"attempted": ctx.n_ticks, "failed": 0,
            "metrics": {"tick_latency_p50_ms": float(np.percentile(lat, 50)),
                        "tick_latency_p95_ms": float(np.percentile(lat, 95))},
            "seconds": done[-1] - t0}


def stretch(ctx):
    due, start, done, _ = _ticks(ctx, ctx.n_ticks, True)
    # each tick's span on the host clock, relative to its own start; the
    # trace reader puts them on the trace's clock through the ticks' ranges
    return {"attempted": ctx.n_ticks, "failed": 0, "cam_frames": ctx.n_ticks * ctx.cams,
            "ticks": ctx.n_ticks,
            "tick_spans": [((due[k] - start[k]) * 1e6, (done[k] - start[k]) * 1e6)
                           for k in range(ctx.n_ticks)]}


def close(ctx):
    if getattr(ctx, "sess", None) is not None:
        ctx.sess.close()
    ctx.sess = None


def artifacts(ctx):
    cams = ctx.cams
    seg = ctx.traffic["frames"]

    def frames_of(k):
        import torch
        return torch.stack([ctx.bank[0, c, k % seg] for c in range(cams)])

    dets = [(ctx.probe.dets.get(k) or [None])[0] for k in ctx.check_ticks]
    samples = [Sample((k, 0), lambda k=k: frames_of(k), ctx.probe.heads.get((k, 0)),
                      dets[k], 1) for k in ctx.head_ticks]
    ts = [k * ctx.traffic["timestamp_step_us"] for k in ctx.check_ticks]
    unit = TrackUnit("segment0", dets, None if cams == 1 else cams, len(ctx.check_ticks),
                     ["live"] * cams, list(range(1, cams + 1)), ts, getattr(ctx, "rows", []),
                     None, ctx.scale, frames=frames_of, check_cams=ctx.check_cams)
    return samples, [unit]
