#!/usr/bin/env python3
"""Run the tracker of several checkouts of this package in one process on one
card: hold their single-camera results bit for bit, time their tracker loop
in turns, and count and time the host ops of one step.

    git archive <commit> waymo_2d_tracking_tpu_torch | tar -x -C old/
    python3 waymo_2d_tracking_tpu_torch/tools/compare_trackers.py parent=old change=.

Two calls of a program may land on two cards or two hosts, and the tracker
loop is bound by the host (the ops it issues), so two versions of the tracker
are compared only like this. The detections are those of one headline chunk
(``chip_smoke.HEADLINE``, seeded random weights, 128 rendered 640x960
frames), computed once by the first checkout and handed to every checkout as
numpy arrays. Each checkout, in the order given and then its reverse: a
warm-up, 3 timed runs of ``track_segment`` over the 128 frames (wall time to
a synchronize), 3 of ``tracker/graph.py track_chunk`` (the captured step
replayed, as the drivers run it; captured before the first), and a
``torch.profiler`` trace of 32 steps (host CPU time of the top-level
``aten`` ops). Every checkout's final state and outputs must equal the
first's; the script exits non-zero otherwise.
"""
from __future__ import annotations

import collections
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402

PKG = "waymo_2d_tracking_tpu_torch"
PRESET = {**cs.HEADLINE, "pipeline": {**cs.HEADLINE["pipeline"], "decode_scale_denom": 1}}


def load(root: str):
    """The package under ``root``, imported afresh, its kernels built."""
    for name in [m for m in sys.modules if m == PKG or m.startswith(PKG + ".")]:
        del sys.modules[name]
    sys.path.insert(0, os.path.abspath(root))
    try:
        import waymo_2d_tracking_tpu_torch as pkg
        from waymo_2d_tracking_tpu_torch import config, tracker, types
        from waymo_2d_tracking_tpu_torch.ops import _cuda
        from waymo_2d_tracking_tpu_torch.tracker import graph
    finally:
        sys.path.pop(0)
    if not pkg.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"{PKG} came from {pkg.__file__}, not {root}")
    _cuda.build_all()
    return config, tracker, types, graph


def headline_detections(root: str):
    config, _, _, _ = load(root)
    from waymo_2d_tracking_tpu_torch.data.synthetic import SyntheticClipConfig, render_video_clip
    from waymo_2d_tracking_tpu_torch.pipeline.run import SegmentPipeline

    frames, _ = render_video_clip(SyntheticClipConfig(num_frames=128, num_objects=12, seed=3),
                                  render_hw=(640, 960))
    pipe = SegmentPipeline(config._update(config.Config(), PRESET), device="cuda")
    images, _ = pipe.preprocess(frames, frames.shape[1:3])
    return pipe.detector.detect(images).to_numpy()


def measure(root: str, dets_np):
    config, tracker, types, graph = load(root)
    cfg = config._update(config.Config(), PRESET).tracker
    dets = types.Detections.from_numpy(dets_np, device="cuda")
    tracker.track_segment(tracker.init_state(cfg, device="cuda"), dets[:8], cfg)
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        state, outs = tracker.track_segment(tracker.init_state(cfg, device="cuda"), dets, cfg)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    graphs, graphed = {}, []
    graph.track_chunk(tracker.init_state(cfg, device="cuda"), dets, cfg, graphs)
    for _ in range(3):
        fresh = tracker.init_state(cfg, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph.track_chunk(fresh, dets, cfg, graphs)
        torch.cuda.synchronize()
        graphed.append((time.perf_counter() - t0) * 1e3)
    st = state
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for t in range(32):
            st, _ = tracker.track_step(st, dets[t], cfg)
        torch.cuda.synchronize()
    top = [e for e in prof.events() if e.name.startswith("aten::")
           and (e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::"))]
    host_us = collections.Counter()
    for e in top:
        host_us[e.name] += e.cpu_time_total / 32
    return walls, graphed, len(top) / 32, host_us, (state.to_numpy(), outs.to_numpy())


def main() -> int:
    trees = dict(arg.split("=", 1) for arg in sys.argv[1:])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    names = list(trees)
    dets_np = headline_detections(trees[names[0]])
    walls, graphs, ops, host, results = {}, {}, {}, {}, {}
    for name in names + names[::-1]:
        w, g, n, h, res = measure(trees[name], dets_np)
        walls.setdefault(name, []).extend(w)
        graphs.setdefault(name, []).extend(g)
        ops[name], host[name] = n, h
        results.setdefault(name, res)
        print(f"{name}: tracker loop over 128 frames {json.dumps([round(x, 1) for x in w])} ms "
              f"eager, {json.dumps([round(x, 2) for x in g])} ms graphed; {n:.1f} top-level "
              f"aten ops a step, {sum(h.values()):.0f} us of their host time under the "
              f"profiler ({card})", flush=True)
    same = {}
    for name in names[1:]:
        same[name] = all(np.array_equal(getattr(a, f), getattr(b, f))
                         for a, b in zip(results[names[0]], results[name])
                         for f in a.__dataclass_fields__)
    delta = sorted(set().union(*host.values()),
                   key=lambda k: -abs(host[names[-1]][k] - host[names[0]][k]))[:15]
    for k in delta:
        print(f"{k:36s} " + " | ".join(f"{n} {host[n][k]:8.1f} us" for n in names))
    print(json.dumps({"card": card, "bit_identical_to_first": same,
                      "median_ms": {n: statistics.median(v) for n, v in walls.items()},
                      "graphed_median_ms": {n: statistics.median(v) for n, v in graphs.items()},
                      "runs_ms": walls, "graphed_runs_ms": graphs, "ops_per_step": ops}))
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
