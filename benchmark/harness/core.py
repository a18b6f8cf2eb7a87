"""One run of one cell: set-up, the measured window (or, with tracing, a
bounded traced stretch), the isolation check, the correctness check, and
the result line.

What is cell-specific lives in files (``spec.py``): the traffic kind's
runner (``traffic/<kind>.py``) builds the program's entry point and drives
it; the metric readers (``metrics/<name>.py``) read the per-layer metrics
from the traced stretch. This module holds what every cell shares.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types
from typing import Optional

import numpy as np
import torch

from benchmark.harness import check, frames, peaks, spec as spec_mod, weights
from benchmark.harness.probe import Probe
from benchmark.harness.trace import Trace, export_events
from benchmark.reference import model as ref_model

BANNED = ("jax", "jaxlib", "flax", "waymo_2d_tracking_tpu")


def process_start_wall() -> float:
    """Wall-clock time at which this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def banned_modules() -> list:
    """Loaded modules whose top-level name is one of BANNED, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def port_config(cfg: dict):
    from waymo_2d_tracking_tpu_torch.config import load_config
    return load_config(overrides={k: cfg[k] for k in ("detector", "tracker", "pipeline")})


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def flops_per_image(cfg: dict) -> float:
    """FLOPs of the reference detector for one letterboxed image and its
    max_detections ReID crops, counted on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference import postprocess as ref_post
    det = cfg["detector"]
    with torch.device("meta"):
        model = ref_model.Detector(det).eval()
        images = torch.empty((1,) + tuple(det["image_size"]) + (3,))
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        _, feats = model(images)
        if det["embed_dim"] > 0:
            lvl0 = min(det["fpn_levels"])
            boxes = torch.empty((1, det["max_detections"], 4), device="meta")
            pooled = ref_post.roi_align(feats[lvl0], boxes, 1.0 / 2 ** lvl0)
            model.embed(pooled.reshape((-1,) + pooled.shape[2:]))
    return float(counter.get_total_flops())


def run(cell: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
        control: bool = False, fault=None) -> dict:
    """Everything but printing. ``fault``: a test hook called with the
    runner's context after set-up, to break the timed path underneath."""
    t_start = process_start_wall()
    dev = torch.device(device)
    cfg = cell["config"]["config"]
    traffic, cellf = cell["traffic"], cell["cell"]
    ctx = types.SimpleNamespace(
        spec=cell, cfg=cfg, traffic=traffic, cellf=cellf, seed=int(seed), seconds=seconds,
        trace=trace, device=dev, rng=np.random.default_rng([int(seed), 7]),
        cams=len(cfg["pipeline"]["cameras"]), hw=tuple(traffic["source_hw"]))
    drv = spec_mod.runner(cell)

    model = weights.make(cfg, ctx.spec["config"]["weights"], dev)
    # the program gets host copies of the weights (it builds its module on the
    # host and moves it); the reference's stay off the card until the check
    model.to("cpu")
    ctx.state_dict = model.state_dict()
    t = time.time()
    ctx.bank, ctx.objects = frames.draw_bank(
        seed, cellf["bank_groups"], ctx.cams, traffic["frames"], traffic["objects"], ctx.hw, dev)
    ctx.bank_np = ctx.bank.numpy()
    log(f"set-up: frames {time.time() - t:.2f} s ({ctx.objects} objects a segment)")
    want_heads, want_dets = drv.plan(ctx)
    if dev.type == "cuda":     # the peak from here on is the program's
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    ctx.out_dir = tempfile.mkdtemp(prefix="bench-out-")
    ctx.probe = Probe(trace, want_heads, want_dets)
    try:
        result = {}
        if not control:
            t = time.time()
            drv.setup(ctx)
            log(f"set-up: the program built and warmed in {time.time() - t:.2f} s")
            if fault is not None:
                fault(ctx)
            _sync(dev)
            ctx.setup_s = time.time() - t_start
            if trace:
                result["trace"] = _traced(drv, ctx)
            else:
                result["window"] = drv.window(ctx)
            _sync(dev)
        result["memory_peak_bytes"] = (int(torch.cuda.max_memory_allocated(dev))
                                       if dev.type == "cuda" else 0)
        found = banned_modules()
        if found:
            raise SystemExit(f"loaded modules of the JAX side: {found}")
        samples, tracks = drv.artifacts(ctx)
        drv.close(ctx)
        ctx.probe.remove()
        ctx.state_dict = None
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        model.to(dev)
        if control:
            check.control_artifacts(model, cfg, samples, tracks, dev)
        t_check = time.time()
        result["numbers"], result["seen"] = check.compare(model, cfg, samples, tracks, dev)
        result["check_s"] = time.time() - t_check
        result["ctx"] = ctx
        return result
    finally:
        shutil.rmtree(ctx.out_dir, ignore_errors=True)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _traced(drv, ctx) -> dict:
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if ctx.device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        with record_function("bench/stretch"):
            info = drv.stretch(ctx)
            _sync(ctx.device)
    info["events"] = export_events(prof)
    return info


def result_line(cell: dict, res: dict) -> dict:
    """The result object, keys in the order the contract reads them; the
    compared numbers, each beside its limit, last."""
    ctx = res["ctx"]
    limits = ctx.cellf["limits"]
    numbers = res["numbers"]
    checks = {k: {"value": _num(v), "limit": limits[k]} for k, v in numbers.items()}
    correct = all(v <= limits[k] for k, v in numbers.items())
    dev = ctx.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": 1, "memory_peak_bytes": res["memory_peak_bytes"]}
    metrics, breakdown = {}, None
    attempted = failed = 0
    if "window" in res:
        win = res["window"]
        attempted, failed = win["attempted"], win["failed"]
        for m in cell["end_to_end"]:
            v = ctx.setup_s if m["name"] == "setup_s" else win["metrics"].get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    elif "trace" in res:
        info = res["trace"]
        tr = Trace(info.pop("events"))
        attempted, failed = info["attempted"], info["failed"]
        view = types.SimpleNamespace(trace=tr, cfg=ctx.cfg, info=info, peaks=peaks,
                                     flops_per_image=flops_per_image(ctx.cfg))
        for m in cell["per_layer"]:
            v = spec_mod.reader(cell, m["name"]).read(view)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s()
        breakdown = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10)}
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["seen"] = res["seen"]
    out["checks"] = checks
    return out


def _num(v):
    return v if math.isfinite(v) else str(v)


def emit(out: dict) -> None:
    """stderr: each compared number beside its limit as the last lines;
    stdout: the result object as the last line."""
    if "seen" in out:
        log("checked: " + ", ".join(f"{k} {v}" for k, v in out.pop("seen").items()))
    for k, v in out["checks"].items():
        log(f"check {k}: {v['value']} (limit {v['limit']})")
    print(json.dumps(out), flush=True)
