"""Rank bodies of the distributed checks.

``parallel/launch.py run_ranks`` starts them, one process a rank: the CPU
tests (``tests/test_torch_{parallel,ring,sharded,train_dp,cli_sharded}.py``)
over gloo at small sizes, and ``chip_smoke.py``'s D phases on the card at
full width. Each body returns what its parent compares with the unsharded
drivers, the JAX package or the other ranks. Frames reach a rank as ``.npy``
files that it maps (``np.load(mmap_mode="r")``), never pickled, and a rank
reads only the frames of the segments it runs. Every body returns its kernel
launches too (zero on the CPU, where the plain versions run).
"""
from __future__ import annotations

import contextlib
import hashlib
import io
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from waymo_2d_tracking_tpu_torch.parallel import sharding as shd


def _kernels():
    from waymo_2d_tracking_tpu_torch.ops import assign, nms, roi_align, topk

    return {"nms_mask": nms.nms_mask_cuda, "auction": assign.auction_kernel_cuda,
            "topk_threshold": topk.topk_threshold_cuda, "roi_align": roi_align.roi_align_cuda}


def launches() -> Dict[str, int]:
    """This process's launches of each CUDA kernel since the last reset."""
    return {k: fn.launches for k, fn in _kernels().items()}


def reset_launches() -> None:
    for fn in _kernels().values():
        fn.launches = 0


def digest(tensors: Dict[str, torch.Tensor]) -> str:
    """SHA-256 of the tensors' bytes in key order."""
    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def run_all(rank: int, world: int, calls: Sequence) -> dict:
    """Several bodies in one spawn: ``calls`` is a list of (name of a body of
    this module, its arguments after rank and world). Returns their results
    and the seconds each took, in order; the kernel launch counts are set to
    0 before each."""
    import sys

    mod = sys.modules[__name__]
    out: dict = {"results": [], "seconds": []}
    for name, args in calls:
        reset_launches()
        t0 = time.perf_counter()
        out["results"].append(getattr(mod, name)(rank, world, *args))
        out["seconds"].append(time.perf_counter() - t0)
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()
    return out


def mesh_case(rank: int, world: int, device: str, store_dir: str) -> dict:
    """``make_mesh``, ``shard_batch`` (data axis alone and with a model axis
    of 2), ``replicate`` and the refusals: a world that ``model_parallel`` or
    ``n_devices`` does not fit, and NCCL on ranks that share a device."""
    mesh = shd.make_mesh(device=device)
    x = np.arange(world * 6, dtype=np.float32).reshape(world * 3, 2)
    rows = shd.shard_batch({"x": x, "y": [torch.from_numpy(x[:, 0].copy())]}, mesh)
    t = torch.full((4,), rank + 0.5, device=shd.mesh_device(mesh))
    shd.replicate({"t": [t]}, mesh)
    out = {"coord": (shd.data_index(mesh), shd.model_index(mesh)), "writer": shd.is_writer(mesh),
           "rows": rows["x"].cpu().numpy(), "rows_y": rows["y"][0].cpu().numpy(),
           "replicated": t.cpu().numpy(), "refusals": []}
    if world % 2 == 0:
        mesh2 = shd.make_mesh(model_parallel=2, device=device)
        out["coord_mp2"] = (shd.data_index(mesh2), shd.model_index(mesh2))
        out["rows_mp2"] = shd.shard_batch(x, mesh2).cpu().numpy()
    for kw in ({"model_parallel": world + 1}, {"n_devices": world + 1}):
        try:
            shd.make_mesh(device=device, **kw)
        except ValueError as e:
            out["refusals"].append(str(e))
    store = dist.FileStore(os.path.join(store_dir, "nccl_store"), world)
    try:
        shd.check_devices(store, rank, world, torch.device("cuda", 0), "nccl")
    except ValueError as e:
        out["nccl"] = str(e)
    return out


def ring_case(rank: int, world: int, device: str, cases: Sequence, cams_list: Sequence = (),
              link_jobs: Sequence = ()) -> dict:
    """``ring_gallery_topmatch`` on each (queries, gallery, valid) of
    ``cases``; ``best_cross_camera_matches`` and ``link_context`` with the
    mesh on each (cams, threshold); ``link_tracks`` with the mesh on each
    (out_dir, linked_dir, threshold)."""
    from waymo_2d_tracking_tpu_torch.parallel.ring import ring_gallery_topmatch
    from waymo_2d_tracking_tpu_torch.pipeline import link

    mesh = shd.make_mesh(device=device)
    rings = []
    for q, g, v in cases:
        sim, idx = ring_gallery_topmatch(torch.from_numpy(q), torch.from_numpy(g),
                                         torch.from_numpy(v), mesh)
        rings.append((sim.cpu().numpy(), idx.cpu().numpy()))
    matches = [(link.best_cross_camera_matches(cams, mesh=mesh),
                link.link_context(cams, threshold=th, mesh=mesh)) for cams, th in cams_list]
    reports = [link.link_tracks(src, linked_dir=dst, threshold=th, mesh=mesh)
               for src, dst, th in link_jobs]
    return {"rings": rings, "matches": matches, "reports": reports, "launches": launches()}


def _segments(plan: Sequence[dict], consumed: Optional[List] = None):
    """SegmentFrames of ``plan`` (context, camera, timestamps, path of a
    (T, H, W, 3) uint8 ``.npy``), made lazily as the stream is walked."""
    from waymo_2d_tracking_tpu_torch.pipeline.run import SegmentFrames

    for p in plan:
        if consumed is not None:
            consumed.append(p["context"])
        yield SegmentFrames(p["context"], p["camera"], list(p["timestamps"]),
                            frames=np.load(p["path"], mmap_mode="r"))


def manifest_keys(out_dir: str) -> List[str]:
    import json

    path = os.path.join(out_dir, "manifest.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line)["key"] for line in f if line.strip()]


def fanout_case(rank: int, world: int, device: str, cfg, out_root: str,
                seg_plan: Sequence[dict] = (), mixed_plan: Sequence[dict] = (),
                mc_cfg=None, ctx_plan: Sequence[dict] = (), seed: int = 0,
                slow_append: float = 0.0) -> dict:
    """The sharded fan-out: ``seg_plan``'s segments through
    ``run_segments_sharded`` (tracks, a rerun, detections only);
    ``mixed_plan``'s (mixed resolutions) through it with the stream's
    consumption and the manifest seen at each step recorded, then in a fresh
    directory with ``fail_after=2`` and resumed; ``ctx_plan``'s cameras
    through ``run_context_groups_sharded`` with ``mc_cfg`` (and a rerun, and
    a context short of a camera). Pipelines from ``seed``. ``slow_append``:
    the mixed plan's fault and resume once more, in another directory, the
    writer sleeping that many seconds before each manifest append of the
    call that raises, so the other ranks leave it and start the resumed call
    first."""
    from waymo_2d_tracking_tpu_torch.pipeline import sharded
    from waymo_2d_tracking_tpu_torch.pipeline.multicam import MultiCamPipeline
    from waymo_2d_tracking_tpu_torch.pipeline.run import SegmentPipeline
    from waymo_2d_tracking_tpu_torch.pipeline.sharded import (
        run_context_groups_sharded,
        run_segments_sharded,
    )

    mesh = shd.make_mesh(device=device)
    out: dict = {"seconds": {}}
    if seg_plan or mixed_plan:
        pipe = SegmentPipeline(cfg, device=device, seed=seed)
    if seg_plan:
        d = os.path.join(out_root, "tracks")
        t0 = time.perf_counter()
        out["tracks"] = run_segments_sharded(pipe, _segments(seg_plan), d, mesh=mesh)
        out["seconds"]["tracks"] = time.perf_counter() - t0
        out["rerun"] = run_segments_sharded(pipe, _segments(seg_plan), d, mesh=mesh)
        t0 = time.perf_counter()
        out["detect"] = run_segments_sharded(pipe, _segments(seg_plan),
                                             os.path.join(out_root, "detect"), mesh=mesh,
                                             detections_only=True)
        out["seconds"]["detect"] = time.perf_counter() - t0
    if mixed_plan:
        d = os.path.join(out_root, "mixed")
        consumed: List[str] = []
        seen: List = []

        def walked():
            for seg in _segments(mixed_plan, consumed):
                seen.append((seg.context_name, manifest_keys(d)))
                yield seg

        out["mixed"] = run_segments_sharded(pipe, walked(), d, mesh=mesh)
        out["consumed"], out["seen"] = consumed, seen
        d = os.path.join(out_root, "fault")
        try:
            run_segments_sharded(pipe, _segments(mixed_plan), d, mesh=mesh, fail_after=2)
        except RuntimeError as e:
            out["fault"] = str(e)
        shd.barrier(mesh)     # the manifest as the writer left it
        out["fault_manifest"] = manifest_keys(d)
        out["resumed"] = run_segments_sharded(pipe, _segments(mixed_plan), d, mesh=mesh)
        out["resumed_manifest"] = manifest_keys(d)
        if slow_append:
            d = os.path.join(out_root, "fault_slow")
            append = sharded.append_manifest

            def slow(out_dir, stats):
                time.sleep(slow_append)
                append(out_dir, stats)

            if shd.is_writer(mesh):
                sharded.append_manifest = slow
            try:
                run_segments_sharded(pipe, _segments(mixed_plan), d, mesh=mesh, fail_after=2)
            except RuntimeError as e:
                out["slow_fault"] = str(e)
            finally:
                sharded.append_manifest = append
            out["slow_resumed"] = run_segments_sharded(pipe, _segments(mixed_plan), d, mesh=mesh)
            out["slow_resumed_manifest"] = manifest_keys(d)
    if ctx_plan:
        cams = len(mc_cfg.pipeline.cameras)
        mc = MultiCamPipeline(mc_cfg, num_cams=cams, device=device, seed=seed)
        d = os.path.join(out_root, "contexts")
        t0 = time.perf_counter()
        out["contexts"] = run_context_groups_sharded(mc, _segments(ctx_plan), d, mesh=mesh)
        out["seconds"]["contexts"] = time.perf_counter() - t0
        out["contexts_rerun"] = run_context_groups_sharded(mc, _segments(ctx_plan), d, mesh=mesh)
        try:
            run_context_groups_sharded(mc, _segments(ctx_plan[1:]),
                                       os.path.join(out_root, "short"), mesh=mesh)
        except ValueError as e:
            out["short_context"] = str(e)
    out["launches"] = launches()
    return out


def train_batch(seed: int, n: int, hw, reid: bool) -> dict:
    """The global batch of a data-parallel check, drawn from ``seed`` in
    every rank (``render_detection_batch``, 6 GT boxes an image; with
    ``reid`` identities that recur across the batch's images)."""
    from waymo_2d_tracking_tpu_torch.data.synthetic import render_detection_batch

    b = render_detection_batch(np.random.default_rng(seed), n, tuple(hw), max_gt=6)
    if reid:
        b["gt_track_ids"] = np.where(b["gt_valid"], np.arange(6)[None, :] % 4, -1).astype(np.int32)
    return b


def train_case(rank: int, world: int, device: str, cfgs: Dict[str, object], batch_size: int,
               ckpt_dir: str, steps_cfg=None, steps: int = 3, timed: int = 0,
               batch_seed: int = 3, evaluate: bool = False) -> dict:
    """Data-parallel training: for each named Config of ``cfgs`` one update's
    gradients, BatchNorm statistics and metrics on the global batch from
    ``batch_seed`` (every rank's digest; rank 0's tensors); then ``steps``
    steps of ``steps_cfg`` (params and EMA digests a rank), a checkpoint
    saved under the mesh and restored on every rank, ``timed`` more steps
    timed and, with ``evaluate``, held-out AP of the replicated weights
    (``evaluate_detector``, the NMS kernel on the card)."""
    from waymo_2d_tracking_tpu_torch.train.train import (
        DetectorTrainer,
        _as_batch,
        evaluate_detector,
    )

    mesh = shd.make_mesh(device=device)
    out: dict = {"cases": {}}
    for name, cfg in cfgs.items():
        tr = DetectorTrainer(cfg, mesh=mesh)
        st = tr.create_state(torch.Generator().manual_seed(0))
        reid = cfg.train.reid_loss_weight > 0
        batch = train_batch(batch_seed, batch_size, cfg.detector.image_size, reid)
        grads, stats, metrics = tr._grads_and_stats(st, _as_batch(batch, tr.device))
        case = {"grads_digest": digest(grads), "stats_digest": digest(stats),
                "metrics": {k: float(v) for k, v in metrics.items()}}
        if rank == 0:
            case["grads"] = {k: v.detach().float().cpu() for k, v in grads.items()}
            case["stats"] = {k: v.detach().cpu() for k, v in stats.items()}
        out["cases"][name] = case
    if steps_cfg is not None:
        tr = DetectorTrainer(steps_cfg, mesh=mesh)
        st = tr.create_state(torch.Generator().manual_seed(0))
        reid = steps_cfg.train.reid_loss_weight > 0
        for i in range(steps):
            st, m = tr.train_step(st, train_batch(batch_seed + 1 + i, batch_size,
                                                  steps_cfg.detector.image_size, reid))
        out["loss"] = float(m["loss"])
        out["params_digest"] = digest(st.params)
        out["ema_digest"] = digest(st.ema_params)
        path = tr.save_checkpoint(st, ckpt_dir)
        back = tr.restore_checkpoint(path, st)
        out["restored_digest"] = digest(back.params) + digest(back.ema_params)
        out["restored_step"] = back.step
        if timed:
            batches = [train_batch(100 + i, batch_size, steps_cfg.detector.image_size, reid)
                       for i in range(timed)]
            if tr.device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in batches:
                st, m = tr.train_step(st, b)
            float(m["loss"])
            out["step_s"] = (time.perf_counter() - t0) / timed
        if evaluate:
            val = train_batch(200, 4, steps_cfg.detector.image_size, False)
            out["val"] = evaluate_detector(tr, st, [val])
    out["launches"] = launches()
    return out


def cli_case(rank: int, world: int, device: str, ports: Sequence[int],
             argvs: Sequence[Sequence[str]]) -> dict:
    """Processes started as a user starts them: the ``W2T_*`` variables
    (gloo over TCP on 127.0.0.1). First ``initialize_multihost`` and an
    all-reduce of ``rank + 1``; then each command line of ``argvs`` through
    ``cli.main`` on its own port (the verb joins and leaves the group itself),
    with its standard output."""
    from waymo_2d_tracking_tpu_torch import cli
    from waymo_2d_tracking_tpu_torch.parallel.multihost import initialize_multihost

    os.environ.update({"W2T_NUM_PROCESSES": str(world), "W2T_PROCESS_ID": str(rank),
                       "W2T_BACKEND": "gloo", "W2T_COORDINATOR": f"127.0.0.1:{ports[0]}"})
    joined = initialize_multihost(device=device)
    t = torch.tensor([float(rank + 1)], device=shd.rank_device(device, rank))
    dist.all_reduce(t)
    out = {"joined": joined, "world": dist.get_world_size(), "total": float(t), "outs": []}
    dist.destroy_process_group()
    for port, argv in zip(ports[1:], argvs):
        os.environ["W2T_COORDINATOR"] = f"127.0.0.1:{port}"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(list(argv))
        out["outs"].append(buf.getvalue())
    out["launches"] = launches()
    return out
