#!/usr/bin/env python3
"""Time several builds of one CUDA kernel source in turns, in one process on
one card, each held to the plain PyTorch version first.

    python3 waymo_2d_tracking_tpu_torch/tools/compare_builds.py nms \\
        parent=old/nms.cu change=waymo_2d_tracking_tpu_torch/csrc/nms.cu
    python3 waymo_2d_tracking_tpu_torch/tools/compare_builds.py roi_align \\
        a=roi_align.cu b=roi_align.cu,-DSOME_MACRO=1

Two calls of a program may land on two cards with other power limits, so two
designs of a kernel (or the parent commit's source and the working tree's)
are compared only like this: every source is built with the package's
``nvcc`` flags plus any ``-D`` given after a comma, loaded with ``ctypes``
under the C entry point of ``csrc/``, checked, and then timed twice in the
order given and its reverse, by CUDA events and by ``torch.profiler`` device
time (``chip_smoke.cuda_time_ms`` / ``device_ms``, the measures of the kernel
table). A build that refuses a shape (the C entry point returns an error) is
reported as refusing it. Inputs are those of ``chip_smoke.py`` phase 1.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from waymo_2d_tracking_tpu_torch.ops import _cuda, nms, roi_align  # noqa: E402


def build(spec: str, out_dir: str):
    name, rest = spec.split("=", 1)
    path, *flags = rest.split(",")
    out = os.path.join(out_dir, f"{name}.so")
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, *flags, "-o", out, path],
                   check=True, capture_output=True, text=True)
    return name, ctypes.CDLL(out)


def stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def call_nms(lib, boxes, valid, thr=0.6):
    b, n = valid.shape
    keep = torch.empty((b, n), dtype=torch.bool, device=boxes.device)
    err = lib.w2t_nms_mask(ctypes.c_void_p(boxes.data_ptr()), ctypes.c_void_p(valid.data_ptr()),
                           ctypes.c_void_p(keep.data_ptr()), ctypes.c_int(b), ctypes.c_int(n),
                           ctypes.c_float(thr), stream())
    return None if err else keep


def call_roi(lib, feats, boxes, scale=0.125, p=7, s=2):
    n, h, w, c = feats.shape
    r = boxes.shape[1]
    out = torch.empty((n, r, p, p, c), dtype=feats.dtype, device=feats.device)
    err = lib.w2t_roi_align(
        ctypes.c_void_p(feats.data_ptr()), ctypes.c_void_p(boxes.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), ctypes.c_int(n), ctypes.c_int(h), ctypes.c_int(w),
        ctypes.c_int(c), ctypes.c_int(r), ctypes.c_int(p), ctypes.c_int(s), ctypes.c_float(scale),
        ctypes.c_int(feats.dtype == torch.bfloat16), stream())
    return None if err else out


def nms_shapes(dev):
    for b, n, seed in ((128, 1024, 1), (8, 1024, 1), (128, 2048, 24), (128, 512, 25)):
        boxes, valid = (t.to(dev) for t in cs.nms_inputs(torch, b, n, seed=seed))
        yield f"(B={b}, N={n})", (boxes, valid), nms.nms_mask_reference(boxes, valid, 0.6)


def roi_shapes(dev):
    g = torch.Generator().manual_seed(8)
    feats = torch.randn(128, 56, 84, 128, generator=g).to(dev).bfloat16()
    boxes = cs.roi_boxes(torch, 128, 64, (448, 672), seed=9).to(dev)
    for images in (1, 8, 128):
        args = (feats[:images], boxes[:images])
        yield (f"{images} x 64 RoIs bf16", args,
               roi_align.roi_align_kernel_reference(*args, 0.125, 7, 2))


def main() -> int:
    kernel, specs = sys.argv[1], sys.argv[2:]
    call, shapes = {"nms": (call_nms, nms_shapes), "roi_align": (call_roi, roi_shapes)}[kernel]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        builds = [build(spec, tmp) for spec in specs]
        for label, args, want in shapes(dev):
            for name, lib in builds + builds[::-1]:
                got = call(lib, *args)
                if got is None:
                    print(f"{kernel} {label} {name}: refused ({card})", flush=True)
                    continue
                torch.cuda.synchronize()
                same = torch.equal(got, want)
                ms = cs.cuda_time_ms(lambda: call(lib, *args), reps=20)
                dms = cs.device_ms(lambda: call(lib, *args), reps=20)
                print(f"{kernel} {label} {name}: equal to plain {same}; {ms:.4f} ms by CUDA "
                      f"events, device time {cs.ms_text(dms)} ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
