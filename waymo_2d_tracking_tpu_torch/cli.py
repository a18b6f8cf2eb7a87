"""Command-line entry points of the port (counterpart of ``cli.py``): the
same verbs, flags and JSON lines as the JAX package's ``w2t``.

  python -m waymo_2d_tracking_tpu_torch.cli track --config configs/headline.yaml \\
      --segments-dir DATA --out-dir OUT
  python -m waymo_2d_tracking_tpu_torch.cli track --from-detections dets.jsonl --out sub.jsonl
  python -m waymo_2d_tracking_tpu_torch.cli serve --socket /tmp/w2t.sock --warmup 1280 1920
  python -m waymo_2d_tracking_tpu_torch.cli eval --pred sub.jsonl --gt gt.jsonl

Config: ``--config`` a yaml preset (``configs/``) plus dotted overrides:
``--set tracker.max_age=5 detector.embed_dim=0``.

The port adds:
- ``--device {cuda,cpu}`` (default ``cuda``): the verbs that compute run on
  the card and raise without one unless given ``--device cpu``;
- ``--params``: a flat flax ``.npz`` (``weights.load_npz``, the fixtures'
  form), a port state dict (``torch.save``; ``import-weights`` and
  ``train`` write them) or a ``train/train.py`` checkpoint, whose EMA
  parameters are served where it has them. Without it the weights are random
  from ``--seed``;
- ``--compile-cache DIR|off``: where the CUDA kernels are built and found
  (``utils/compile_cache.py``);
- ``export`` (also ``export-savedmodel``): a ``torch.export`` program
  (``io_out/export.py``), ``--platform {cpu,cuda}``.

``--sharded`` (``track``, ``track --multicam``, ``detect``, ``link``,
``train``) runs one process a card: start one process for each card with
``W2T_COORDINATOR=host:port W2T_NUM_PROCESSES=N W2T_PROCESS_ID=i`` (and
``W2T_BACKEND`` to pick ``gloo`` over the default NCCL for CUDA;
``parallel/multihost.py``). Without the variables the verb runs on a world of
one on ``--device``, which equals the unsharded verb. The writing rank
prints.

``bench`` runs the port's benchmark in this process's place: ``python3
benchmark/run.py`` from the repository's root, as ``BENCHMARK.json`` runs
it, given the verb's arguments unchanged (``--workload <cell> --seed <n>
--seconds <s> --trace <0|1>``; the JAX verb's row flags are not taken).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from typing import List, Optional

_ONLINE_SHARDED = ("--online is a single-host serving path; it does not compose with "
                   "--sharded (fan streams across processes instead, one OnlineTracker per chip)")


def _parse_overrides(pairs: List[str]) -> dict:
    out: dict = {}
    for pair in pairs:
        key, _, raw = pair.partition("=")
        try:
            value = json.loads(raw)
        except json.JSONDecodeError:
            value = raw
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


def _load_config(args):
    """``--config`` (a yaml preset) plus ``--set``."""
    from waymo_2d_tracking_tpu_torch.config import load_config

    return load_config(args.config, _parse_overrides(args.set or []))


@contextlib.contextmanager
def _mesh_session(args):
    """The mesh of a ``--sharded`` verb: over every process started with the
    ``W2T_*`` variables, else a world of one on ``--device``. A process group
    this verb made is destroyed when it ends."""
    import torch.distributed as dist

    from waymo_2d_tracking_tpu_torch.parallel import multihost, sharding

    made = not dist.is_initialized()
    if made:
        multihost.initialize_multihost(device=args.device)
    try:
        yield sharding.make_mesh(device=args.device)
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()


def _enable_compile_cache(args) -> str:
    """Point the kernels' build at ``--compile-cache`` (else
    ``W2T_COMPILE_CACHE``, else the package's ``_build/``)."""
    from waymo_2d_tracking_tpu_torch.utils.compile_cache import enable_compile_cache

    return enable_compile_cache(getattr(args, "compile_cache", None))


def _load_params(path: str, cfg):
    """``--params``: a flat flax ``.npz``, a port state dict, or a training
    checkpoint (``{"params", "opt_state", ...}``: its EMA parameters where it
    has them, else its parameters, with its BatchNorm statistics, over the
    detector's own buffers)."""
    import torch

    from waymo_2d_tracking_tpu_torch import weights

    if path.endswith(".npz"):
        return weights.from_flax_numpy(weights.load_npz(path))
    tree = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(tree, dict) and "params" in tree and "opt_state" in tree:
        from waymo_2d_tracking_tpu_torch.models.detector import Detector

        sd = dict(Detector(cfg.detector).state_dict())
        sd.update(tree.get("ema_params") or tree["params"])
        sd.update(tree.get("batch_stats", {}))
        return sd
    return tree


def _params(args, cfg):
    return _load_params(args.params, cfg) if args.params else None


def cmd_track(args):
    cfg = _load_config(args)
    if args.from_detections:
        return _track_from_detections(cfg, args)
    _enable_compile_cache(args)
    from waymo_2d_tracking_tpu_torch.utils.profiling import trace

    if args.video:
        args.online = True  # a video file is a stream
    if args.online:
        if args.sharded:
            raise SystemExit(_ONLINE_SHARDED)
        with trace(args.profile):
            return _track_online(cfg, args)
    if args.sharded:
        with _mesh_session(args) as mesh:
            return _track_chunked(cfg, args, mesh)
    return _track_chunked(cfg, args, None)


def _track_chunked(cfg, args, mesh):
    """The chunked drivers, unsharded (``mesh`` None) or fanned over the
    mesh's ranks (``pipeline/sharded.py``)."""
    from waymo_2d_tracking_tpu_torch.data.waymo import iter_segments
    from waymo_2d_tracking_tpu_torch.parallel.sharding import is_writer
    from waymo_2d_tracking_tpu_torch.utils.profiling import trace

    sd = _params(args, cfg)
    segments = iter_segments(args.segments_dir, cameras=cfg.pipeline.cameras)
    fail_after = args.fail_after_n_segments
    if args.multicam:
        from waymo_2d_tracking_tpu_torch.pipeline.multicam import (
            MultiCamPipeline,
            run_context_groups,
        )
        from waymo_2d_tracking_tpu_torch.pipeline.sharded import run_context_groups_sharded

        pipeline = MultiCamPipeline(cfg, num_cams=len(cfg.pipeline.cameras), state_dict=sd,
                                    device=args.device, seed=args.seed)
        with trace(args.profile):
            if mesh is None:
                stats = run_context_groups(pipeline, segments, args.out_dir,
                                           fail_after=fail_after)
            else:
                stats = run_context_groups_sharded(pipeline, segments, args.out_dir, mesh=mesh,
                                                   fail_after=fail_after)
    else:
        from waymo_2d_tracking_tpu_torch.pipeline.run import SegmentPipeline, run_segments
        from waymo_2d_tracking_tpu_torch.pipeline.sharded import run_segments_sharded

        pipeline = SegmentPipeline(cfg, sd, device=args.device, seed=args.seed)
        with trace(args.profile):
            if mesh is None:
                stats = run_segments(pipeline, segments, args.out_dir, fail_after=fail_after)
            else:
                stats = run_segments_sharded(pipeline, segments, args.out_dir, mesh=mesh,
                                             fail_after=fail_after)
    if mesh is None or is_writer(mesh):
        for s in stats:
            print(json.dumps(s))


def _track_online(cfg, args):
    """Streaming path (``pipeline/online.py``): one frame per device step.
    The same output files as the chunked driver; each segment's stats line
    also gives its serving latency percentiles."""
    from waymo_2d_tracking_tpu_torch.data.waymo import iter_segments
    from waymo_2d_tracking_tpu_torch.io_out import submission as subm
    from waymo_2d_tracking_tpu_torch.io_out.postprocess import interpolate_gaps
    from waymo_2d_tracking_tpu_torch.pipeline.online import OnlineTracker

    if args.multicam:
        return _track_online_multicam(cfg, args)
    sess = OnlineTracker(cfg, _params(args, cfg), device=args.device, seed=args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    warmed = None
    try:
        if args.video:
            from waymo_2d_tracking_tpu_torch.data.video import iter_video_frames

            stem = os.path.splitext(os.path.basename(args.video))[0]
            sess.reset(clear_latency=True)
            sess.context_name = stem
            records, stamps = [], []
            for ts, frame in iter_video_frames(args.video):
                src_hw = tuple(frame.shape[:2])
                if warmed != src_hw:
                    sess.warmup(src_hw)
                    warmed = src_hw
                records.extend(sess.step(frame, ts))
                stamps.append(ts)
            records = interpolate_gaps(records, stamps, cfg.pipeline.interp_max_gap)
            subm.write_jsonl(os.path.join(args.out_dir, f"{stem}_1.jsonl"), records)
            print(json.dumps({
                "context": stem, "camera": sess.camera_name, "frames": len(stamps),
                "records": len(records), "latency": sess.latency_stats(),
            }))
            return
        for seg in iter_segments(args.segments_dir, cameras=cfg.pipeline.cameras):
            # this segment's percentiles, not a window over every segment
            sess.reset(clear_latency=True)
            sess.context_name = seg.context_name
            sess.camera_name = seg.camera_name
            # compressed frames decode at decode_scale_denom in the session
            src_hw = (seg.scaled_hw(cfg.pipeline.decode_scale_denom)
                      if seg.jpeg_frames is not None else seg.source_hw())
            if warmed != src_hw:
                sess.warmup(src_hw)
                warmed = src_hw
            frames = seg.jpeg_frames if seg.jpeg_frames is not None else list(seg.frames)
            records = []
            for ts, frame in zip(seg.timestamps, frames):
                records.extend(sess.step(frame, ts))
            records = interpolate_gaps(records, list(seg.timestamps),
                                       cfg.pipeline.interp_max_gap)
            subm.write_jsonl(
                os.path.join(args.out_dir, f"{seg.context_name}_{seg.camera_name}.jsonl"),
                records)
            print(json.dumps({
                "context": seg.context_name, "camera": seg.camera_name,
                "frames": seg.num_frames, "records": len(records),
                "latency": sess.latency_stats(),
            }))
    finally:
        sess.close()


def _track_online_multicam(cfg, args):
    """``--online --multicam``: each tick runs every camera of a context
    through one detector batch and the camera-batched tracker step
    (``OnlineMultiCamTracker``); one file per (context, camera)."""
    from waymo_2d_tracking_tpu_torch.data.waymo import iter_segments
    from waymo_2d_tracking_tpu_torch.io_out import submission as subm
    from waymo_2d_tracking_tpu_torch.io_out.postprocess import interpolate_gaps
    from waymo_2d_tracking_tpu_torch.pipeline.online import OnlineMultiCamTracker

    num_cams = len(cfg.pipeline.cameras)
    sess = OnlineMultiCamTracker(cfg, camera_names=list(range(1, num_cams + 1)),
                                 state_dict=_params(args, cfg), device=args.device,
                                 seed=args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    by_ctx = {}
    for seg in iter_segments(args.segments_dir, cameras=cfg.pipeline.cameras):
        by_ctx.setdefault(seg.context_name, []).append(seg)
    warmed = None
    try:
        for ctx in sorted(by_ctx):
            segs = sorted(by_ctx[ctx], key=lambda s: s.camera_name)
            if len(segs) != num_cams:
                raise ValueError(f"context {ctx} has {len(segs)} cameras, config expects "
                                 f"{num_cams} ({cfg.pipeline.cameras})")
            # a camera's frame t must meet every other camera's frame t
            ts0 = tuple(int(t) for t in segs[0].timestamps)
            for s in segs[1:]:
                if tuple(int(t) for t in s.timestamps) != ts0:
                    raise SystemExit(
                        f"multicam context {ctx} needs aligned timestamps across cameras "
                        f"(camera {s.camera_name} differs from camera {segs[0].camera_name})")
            sess.reset(clear_latency=True)
            sess.context_name = ctx
            sess.camera_names = [s.camera_name for s in segs]
            src_hw = (segs[0].scaled_hw(cfg.pipeline.decode_scale_denom)
                      if segs[0].jpeg_frames is not None else segs[0].source_hw())
            if warmed != src_hw:
                sess.warmup(src_hw)
                warmed = src_hw
            per_cam = [s.jpeg_frames if s.jpeg_frames is not None else list(s.frames)
                       for s in segs]
            records = []
            for t, ts in enumerate(segs[0].timestamps):
                records.extend(sess.step([fr[t] for fr in per_cam], ts))
            records = interpolate_gaps(records, list(ts0), cfg.pipeline.interp_max_gap)
            for s in segs:
                subm.write_jsonl(os.path.join(args.out_dir, f"{ctx}_{s.camera_name}.jsonl"),
                                 [r for r in records if r.camera_name == s.camera_name])
            print(json.dumps({
                "context": ctx, "cameras": [s.camera_name for s in segs],
                "frames": segs[0].num_frames, "records": len(records),
                "latency": sess.latency_stats(),
            }))
    finally:
        sess.close()


def _track_from_detections(cfg, args):
    """Tracker only, over precomputed detections (``pipeline/offline.py``,
    shared with ``tune``)."""
    from waymo_2d_tracking_tpu_torch.io_out import submission as subm
    from waymo_2d_tracking_tpu_torch.pipeline.offline import track_detection_rows

    _enable_compile_cache(args)
    try:
        records = track_detection_rows(cfg, subm.read_jsonl(args.from_detections),
                                       device=args.device)
    except ValueError as e:
        raise SystemExit(str(e))
    n = subm.write_jsonl(args.out, records)
    print(json.dumps({"records": n, "out": args.out}))


def cmd_detect(args):
    """Detection only: per-frame detections JSONL. With ``--sharded`` the
    segments fan over the ranks into per-segment files in ``--out-dir``
    (default ``<out>.d``), and exactly this run's segments are merged into
    ``--out``."""
    _enable_compile_cache(args)
    from waymo_2d_tracking_tpu_torch.data.waymo import iter_segments
    from waymo_2d_tracking_tpu_torch.io_out import submission as subm
    from waymo_2d_tracking_tpu_torch.pipeline.run import SegmentPipeline
    from waymo_2d_tracking_tpu_torch.utils.profiling import trace

    cfg = _load_config(args)
    segments = iter_segments(args.segments_dir, cameras=cfg.pipeline.cameras)
    if args.sharded:
        with _mesh_session(args) as mesh, trace(args.profile):
            # made once this process holds its rank's card
            pipeline = SegmentPipeline(cfg, _params(args, cfg), device=args.device,
                                       seed=args.seed)
            records = _detect_sharded(pipeline, segments, args, mesh)
        if records is None:
            return
    else:
        pipeline = SegmentPipeline(cfg, _params(args, cfg), device=args.device, seed=args.seed)
        records = []
        with trace(args.profile):
            for seg in segments:
                recs, stats = pipeline.run_segment(seg, detections_only=True)
                records.extend(recs)
                print(json.dumps(stats), file=sys.stderr)
    n = subm.write_jsonl(args.out, records)
    print(json.dumps({"records": n, "out": args.out}))


def _detect_sharded(pipeline, segments, args, mesh):
    """``detect --sharded``: the stateless fan-out, then the merge of the
    segment files of exactly the segments this run was given (manifest-resumed
    ones included, stale keys of an earlier run in the same ``--out-dir``
    not). Returns the merged records on the writing rank, None elsewhere."""
    from waymo_2d_tracking_tpu_torch.io_out import submission as subm
    from waymo_2d_tracking_tpu_torch.parallel.sharding import is_writer
    from waymo_2d_tracking_tpu_torch.pipeline.manifest import segment_key
    from waymo_2d_tracking_tpu_torch.pipeline.sharded import run_segments_sharded

    out_dir = args.out_dir or (args.out + ".d")
    seen_keys = []

    def recording(it):
        for seg in it:
            seen_keys.append((seg.context_name, seg.camera_name))
            yield seg

    stats = run_segments_sharded(pipeline, recording(segments), out_dir, mesh=mesh,
                                 detections_only=True)
    if not is_writer(mesh):
        return None
    records = []
    for ctx, cam in seen_keys:
        seg_file = os.path.join(out_dir, f"{ctx}_{cam}.jsonl")
        if not os.path.exists(seg_file):
            raise FileNotFoundError(
                f"detect --sharded: {seg_file} missing for completed segment "
                f"{segment_key(ctx, cam)} -- out-dir partially cleaned? delete its "
                "manifest.jsonl line to recompute")
        records.extend(subm.read_jsonl(seg_file))
    for s in stats:
        print(json.dumps(s), file=sys.stderr)
    return records


def cmd_submit(args):
    """JSONL track outputs -> the Waymo submission protobuf."""
    from waymo_2d_tracking_tpu_torch.io_out import submission as subm

    records = []
    for path in args.inputs:
        records.extend(subm.read_jsonl(path))
    n = subm.write_waymo_pb(args.out, records)
    print(json.dumps({"objects": n, "out": args.out}))


def cmd_import_mot(args):
    """MOTChallenge text files -> TrackRecord JSONL (``io_out/motchallenge.py``)."""
    from waymo_2d_tracking_tpu_torch.io_out import submission as subm
    from waymo_2d_tracking_tpu_torch.io_out.motchallenge import read_mot, read_mot_tree

    if args.context:
        if not os.path.isfile(args.input):
            raise SystemExit(
                "import-mot: --context applies to a single-file input; "
                "directory inputs name each sequence by its own file/dir")
        records, stats = read_mot(args.input, context_name=args.context, gt=args.gt,
                                  camera_name=args.camera)
    else:
        records, stats = read_mot_tree(args.input, gt=args.gt, camera_name=args.camera)
    n = subm.write_jsonl(args.out, records)
    out = {"records": n, "out": args.out, "skipped_ignore": stats.skipped_ignore,
           "skipped_class": stats.skipped_class}
    if stats.ignore:
        # don't-care regions as a sidecar for `eval --ignore`
        ignore_path = os.path.splitext(args.out)[0] + ".ignore.jsonl"
        out["ignore_records"] = subm.write_jsonl(ignore_path, stats.ignore)
        out["ignore_out"] = ignore_path
    print(json.dumps(out))


def cmd_export_mot(args):
    """TrackRecord JSONL -> MOT result files, one per sequence / camera."""
    from waymo_2d_tracking_tpu_torch.io_out import submission as subm
    from waymo_2d_tracking_tpu_torch.io_out.motchallenge import write_mot

    records = []
    for path in args.inputs:
        records.extend(subm.read_jsonl(path))
    written = write_mot(records, args.out_dir)
    print(json.dumps({"files": written, "out_dir": args.out_dir}))


def cmd_export(args):
    """Detector -> ``torch.export`` program (``io_out/export.py``).
    ``--platform cuda`` keeps the NMS kernel, ``cpu`` its plain version;
    both need the port's ``ops`` importable where the program is loaded."""
    _enable_compile_cache(args)
    from waymo_2d_tracking_tpu_torch.io_out.export import export_program

    cfg = _load_config(args)
    info = export_program(cfg, _params(args, cfg), args.out, batch_size=args.batch,
                          platform=args.platform or args.device, seed=args.seed)
    print(json.dumps(info))


def cmd_tune(args):
    """Tracker hyperparameter random search over precomputed detections
    (``pipeline/tune.py``), scored with pooled CLEAR-MOT / IDF1 against
    ``--gt``."""
    _enable_compile_cache(args)
    from waymo_2d_tracking_tpu_torch.io_out import submission as subm
    from waymo_2d_tracking_tpu_torch.pipeline.tune import tune_tracker

    cfg = _load_config(args)
    det_rows = subm.read_jsonl(args.from_detections)
    gt_rows = subm.read_jsonl(args.gt)
    try:
        report = tune_tracker(det_rows, gt_rows, cfg, trials=args.trials, seed=args.seed,
                              objective=args.objective, iou_threshold=args.iou,
                              workers=args.workers or 0, device=args.device)
    except ValueError as e:
        raise SystemExit(str(e))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    best = report["best"]
    print(json.dumps({
        "objective": report["objective"],
        "best_trial": best["trial"],
        report["objective"]: best[report["objective"]],
        "baseline": next((r[report["objective"]] for r in report["results"]
                          if r["trial"] == -1), None),
        "set_flags": report["best_overrides"],
        "out": args.out,
    }))


def cmd_interp(args):
    """Offline gap interpolation over a track JSONL."""
    from waymo_2d_tracking_tpu_torch.io_out import submission as subm
    from waymo_2d_tracking_tpu_torch.io_out.postprocess import interpolate_gaps_offline

    records = subm.read_jsonl(args.input)
    out = interpolate_gaps_offline(records, max_gap=args.max_gap)
    n = subm.write_jsonl(args.out, out)
    print(json.dumps({
        "records_in": len(records), "records_out": n,
        "interpolated": n - len(records), "out": args.out,
    }))


def _eval_key_worker(task):
    """One (context, camera) evaluation; module-level for ``eval --workers``."""
    key, gt_frames, hyp_frames, iou, hota = task
    from waymo_2d_tracking_tpu_torch.eval.mot import evaluate_mot

    m = evaluate_mot(gt_frames, hyp_frames, iou_threshold=iou)
    hm = None
    if hota:
        from waymo_2d_tracking_tpu_torch.eval.hota import evaluate_hota

        hm = evaluate_hota(gt_frames, hyp_frames)
    return key, m, hm


def _to_frames(rows):
    by_seg = {}
    for r in rows:
        by_seg.setdefault((r.context_name, r.camera_name), {}).setdefault(
            r.timestamp_micros, []).append(r)
    return by_seg


def _boxes(np, rows):
    return np.array([r.to_xyxy() for r in rows]).reshape(-1, 4)


def _eval_rows(np, pool, args, pred_rows, gt_rows, per_key: bool):
    """(per-(context, camera) rows if ``per_key``, the pooled row or None):
    the union of keys and timestamps, ids interned per (context, camera),
    pooled exactly from per-key counts (``combine_mot`` / ``combine_hota``)."""
    from waymo_2d_tracking_tpu_torch.eval.mot import combine_mot

    pred, gt = _to_frames(pred_rows), _to_frames(gt_rows)
    intern: dict = {}

    def ids(key, rows_):
        return np.array([intern.setdefault((key, r.object_id), len(intern)) for r in rows_],
                        dtype=np.int64)

    tasks = []
    for key in sorted(set(gt) | set(pred)):
        stamps = sorted(set(gt.get(key, {})) | set(pred.get(key, {})))
        gt_frames, hyp_frames = [], []
        for ts in stamps:
            g = gt.get(key, {}).get(ts, [])
            h = pred.get(key, {}).get(ts, [])
            gt_frames.append((ids(key, g), _boxes(np, g)))
            hyp_frames.append((ids(key, h), _boxes(np, h)))
        tasks.append((key, gt_frames, hyp_frames, args.iou, bool(args.hota)))
    if pool is not None and len(tasks) > 1:
        results = list(pool.map(_eval_key_worker, tasks))
    else:
        results = [_eval_key_worker(t) for t in tasks]
    agg, mot_parts, hota_parts = {}, [], []
    for key, m, hm in results:
        mot_parts.append(m)
        if hm is not None:
            hota_parts.append(hm)
        if per_key:
            row = m.as_dict()
            if hm is not None:
                row.update(hm.as_dict())
            agg[f"{key[0]}/{key[1]}"] = row
    pooled = None
    if mot_parts and (not per_key or len(agg) > 1):
        pooled = combine_mot(mot_parts).as_dict()
        if args.hota:
            from waymo_2d_tracking_tpu_torch.eval.hota import combine_hota

            pooled.update(combine_hota(hota_parts).as_dict())
    return agg, pooled


def _suppress_on_ignore(np, pred_rows, gt_rows, ignore_rows):
    """Predictions on don't-care regions removed before any scoring (the MOT
    protocol's distractor removal, at its fixed IoU 0.5)."""
    from waymo_2d_tracking_tpu_torch.eval.mot import suppress_ignored

    ign, gt_by = _to_frames(ignore_rows), _to_frames(gt_rows)
    kept = []
    for key, by_ts in _to_frames(pred_rows).items():
        for ts, rows in by_ts.items():
            g = gt_by.get(key, {}).get(ts, [])
            i = ign.get(key, {}).get(ts, [])
            if not i:
                kept.extend(rows)
                continue
            (kept_ids, _), = suppress_ignored(
                [(np.arange(len(g)), _boxes(np, g))], [(np.arange(len(rows)), _boxes(np, rows))],
                [_boxes(np, i)], iou_threshold=0.5)
            kept.extend(rows[k] for k in kept_ids)
    return kept


def cmd_eval(args):
    """CLEAR-MOT / IDF1 (and HOTA) against ground truth, per (context,
    camera), pooled, and per class."""
    import numpy as np

    from waymo_2d_tracking_tpu_torch.io_out import submission as subm

    pred_rows = subm.read_jsonl(args.pred)
    gt_rows = subm.read_jsonl(args.gt)
    if args.ignore:
        kept = _suppress_on_ignore(np, pred_rows, gt_rows, subm.read_jsonl(args.ignore))
        n_removed = len(pred_rows) - len(kept)
        pred_rows = kept
        if n_removed:
            print(json.dumps({"suppressed_on_ignore_regions": n_removed}))
    pool = None
    if (args.workers or 0) > 1:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        pool = ProcessPoolExecutor(max_workers=args.workers, mp_context=mp.get_context("spawn"))
    try:
        agg, pooled = _eval_rows(np, pool, args, pred_rows, gt_rows, per_key=True)
        if pooled is not None:
            agg["OVERALL"] = pooled
        if args.per_class:
            # Waymo scores classes separately: a prediction of the wrong type
            # never matches the GT it overlaps
            types = sorted({r.object_type for r in gt_rows} | {r.object_type for r in pred_rows})
            for t in types:
                _, pooled_c = _eval_rows(np, pool, args,
                                         [r for r in pred_rows if r.object_type == t],
                                         [r for r in gt_rows if r.object_type == t],
                                         per_key=False)
                if pooled_c is not None:
                    agg[f"CLASS_{subm.WAYMO_TYPE_NAMES.get(t, t)}"] = pooled_c
    finally:
        if pool is not None:
            pool.shutdown()
    print(json.dumps(agg, indent=2))


def cmd_eval_det(args):
    """COCO-style detection AP of a detections / tracks JSONL against GT."""
    from waymo_2d_tracking_tpu_torch.eval.ap import evaluate_detections, records_to_frames
    from waymo_2d_tracking_tpu_torch.io_out import submission as subm

    pred = records_to_frames(subm.read_jsonl(args.pred), with_scores=True)
    gt = records_to_frames(subm.read_jsonl(args.gt), with_scores=False)
    out = evaluate_detections(pred, gt, num_classes=args.num_classes)
    print(json.dumps({k: round(v, 5) for k, v in out.items()}, indent=2))


def cmd_train(args):
    """Train the detector (``train/train.py train_loop``) on COCO-converted
    data or synthetic batches; writes checkpoints and the serving state dict
    ``<checkpoint_dir>/export`` (the EMA parameters where enabled). With
    ``--sharded``, data parallel over the ranks (every rank draws the same
    global batches); the writing rank saves and prints."""
    _enable_compile_cache(args)
    if args.sharded:
        with _mesh_session(args) as mesh:
            return _train(args, mesh)
    return _train(args, None)


def _train(args, mesh):
    import numpy as np
    import torch

    from waymo_2d_tracking_tpu_torch.data.synthetic import render_detection_batch
    from waymo_2d_tracking_tpu_torch.train.train import DetectorTrainer, train_loop

    cfg = _load_config(args)
    trainer = DetectorTrainer(cfg, mesh=mesh, device=args.device)
    hw = tuple(cfg.detector.image_size)
    if args.data_dir:
        from waymo_2d_tracking_tpu_torch.data.coco import coco_batch_iterator

        data = coco_batch_iterator(
            args.data_dir, cfg.train.batch_size, hw, seed=args.seed,
            flip_augment=cfg.train.aug_flip, scale_range=tuple(cfg.train.aug_scale_range),
            color_jitter=cfg.train.aug_color_jitter, num_workers=cfg.train.input_workers,
            prefetch_depth=cfg.train.input_prefetch,
            # the ReID metric loss needs a track to recur within a batch
            sample_by_context=cfg.train.reid_loss_weight > 0, device=trainer.device)
    else:
        rng = np.random.default_rng(args.seed)

        def synth():
            while True:
                yield render_detection_batch(rng, cfg.train.batch_size, hw)

        data = synth()
    val_batches = None
    if args.val_every:
        if args.val_dir:
            from waymo_2d_tracking_tpu_torch.data.coco import coco_batch_iterator

            val_iter = coco_batch_iterator(args.val_dir, cfg.train.batch_size, hw,
                                           flip_augment=False, device=trainer.device)
            val_batches = [next(val_iter) for _ in range(args.val_batches)]
        else:
            # held-out synthetic batches from a seed training never sees
            val_rng = np.random.default_rng(args.seed + 10_000)
            val_batches = [render_detection_batch(val_rng, cfg.train.batch_size, hw)
                           for _ in range(args.val_batches)]
    state = train_loop(trainer, data, num_steps=args.steps or cfg.train.total_steps,
                       checkpoint_every=cfg.train.checkpoint_every, val_batches=val_batches,
                       val_every=args.val_every,
                       generator=torch.Generator().manual_seed(args.seed))
    trainer.save_checkpoint(state)
    export = os.path.abspath(os.path.join(cfg.train.checkpoint_dir, "export"))
    if trainer.is_writer:
        torch.save({k: v.cpu() for k, v in trainer.eval_variables(state).items()}, export)
        print(json.dumps({"step": int(state.step), "export": export}))


def cmd_link(args):
    """Cross-camera identity linking over track files and their galleries;
    ``--sharded`` scores through the ring-sharded gallery over the ranks."""
    from waymo_2d_tracking_tpu_torch.pipeline.link import link_tracks

    if not args.sharded:
        print(json.dumps(link_tracks(args.out_dir, linked_dir=args.linked_dir,
                                     threshold=args.threshold)))
        return
    from waymo_2d_tracking_tpu_torch.parallel.sharding import is_writer

    with _mesh_session(args) as mesh:
        report = link_tracks(args.out_dir, linked_dir=args.linked_dir,
                             threshold=args.threshold, mesh=mesh)
        if is_writer(mesh):
            print(json.dumps(report))


def cmd_draw(args):
    """Track boxes drawn onto frames (one JPEG a frame; OpenCV)."""
    from waymo_2d_tracking_tpu_torch.data.waymo import iter_segments
    from waymo_2d_tracking_tpu_torch.io_out import submission as subm
    from waymo_2d_tracking_tpu_torch.utils.viz import render_segment

    cfg = _load_config(args)
    records = subm.read_jsonl(args.tracks)
    total = 0
    videos = []
    stem, ext = os.path.splitext(args.video) if args.video else (None, None)
    for i, seg in enumerate(iter_segments(args.segments_dir, cameras=cfg.pipeline.cameras)):
        video_path = None
        if args.video:
            # the first segment gets the requested path, later ones siblings
            video_path = (args.video if i == 0
                          else f"{stem}_{seg.context_name}_{seg.camera_name}{ext}")
            videos.append(video_path)
        total += render_segment(seg, records, args.out_dir, max_frames=args.max_frames,
                                video_path=video_path, fps=args.fps)
    out = {"frames": total, "out": args.out_dir}
    if videos:
        out["videos"] = videos
    print(json.dumps(out))


def cmd_import_weights(args):
    """torchvision ``.pth`` -> the port's state dict (``train/port_torch.py``)."""
    from waymo_2d_tracking_tpu_torch.train.port_torch import import_weights

    cfg = _load_config(args)
    report = import_weights(args.ckpt, args.out, cfg=cfg.detector, seed=args.seed)
    print(json.dumps({k: report[k] for k in ("out", "n_imported", "n_skipped_shape",
                                             "n_missing")}))
    if args.verbose:
        print(json.dumps(report, indent=2))


def cmd_convert(args):
    from waymo_2d_tracking_tpu_torch.data.coco import convert_segments_to_coco

    n = convert_segments_to_coco(args.segments_dir, args.out_dir)
    print(json.dumps({"images": n, "out": args.out_dir}))


def _write_state_file(server, path: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(server.state_bytes())
        f.flush()
        os.fsync(f.fileno())          # durable before the rename
    os.replace(tmp, path)             # atomic against a crash mid-write


def cmd_serve(args):
    """Long-lived serving daemon over one camera stream or rig
    (``pipeline/server.py``): the JAX package's length-prefixed JSON protocol
    over AF_UNIX or localhost TCP. A device fault ends it non-zero; the state
    file is then not written."""
    _enable_compile_cache(args)
    from waymo_2d_tracking_tpu_torch.pipeline.server import TrackingServer, is_device_fault
    from waymo_2d_tracking_tpu_torch.utils.profiling import trace

    if (args.socket is None) == (args.port is None):
        raise SystemExit("serve: pass exactly one of --socket PATH / --port N")
    cfg = _load_config(args)
    server = TrackingServer(cfg, _params(args, cfg), device=args.device, seed=args.seed,
                            camera_name=args.camera, multicam=args.multicam)
    if args.warmup:
        # full-resolution source dims: the raw shape and the scaled one
        server.warmup_source((int(args.warmup[0]), int(args.warmup[1])))
    if args.state_file and os.path.exists(args.state_file):
        # resume identities from the previous incarnation; a corrupt or
        # mismatched file must not block the restart: warn, serve fresh
        try:
            with open(args.state_file, "rb") as f:
                server.load_state(f.read())
            print(json.dumps({"restored": args.state_file}), file=sys.stderr)
        except Exception as e:
            if is_device_fault(e):
                raise
            print(json.dumps({"restore_failed": args.state_file,
                              "error": f"{type(e).__name__}: {e}",
                              "action": "serving with fresh state"}), file=sys.stderr)

    def on_ready(addr):
        print(json.dumps({"ready": True,
                          "addr": list(addr) if isinstance(addr, tuple) else addr}), flush=True)

    try:
        with trace(args.profile):
            n = server.serve(socket_path=args.socket, port=args.port,
                             max_requests=args.max_requests, on_ready=on_ready)
    except Exception as e:
        if args.state_file and not is_device_fault(e):
            _write_state_file(server, args.state_file)
        raise
    finally:
        server.close()
    if args.state_file:
        _write_state_file(server, args.state_file)
    print(json.dumps({"requests": n, "latency": server.sess.latency_stats()}))


def cmd_doctor(args):
    """Environment report (one JSON object): torch and its CUDA, the card,
    ``nvcc`` and the built kernels, the native host libraries, optional
    dependencies, presets. Status ``ok`` only with a card."""
    import importlib
    import shutil

    import torch

    from waymo_2d_tracking_tpu_torch.utils.compile_cache import built_kernels, resolve_cache_dir

    report = {"torch": {"version": torch.__version__, "cuda": torch.version.cuda,
                        "cuda_available": torch.cuda.is_available(),
                        "device_count": torch.cuda.device_count()}}
    if torch.cuda.is_available():
        report["torch"]["devices"] = [torch.cuda.get_device_name(i)
                                      for i in range(torch.cuda.device_count())]
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    build_dir = resolve_cache_dir(args.compile_cache)
    report["kernels"] = {"nvcc": nvcc if os.path.exists(nvcc) else None,
                         "build_dir": build_dir,
                         "built": built_kernels(build_dir) if build_dir else []}
    native = {}
    try:
        from waymo_2d_tracking_tpu_torch.data import _native

        route = _native.jpeg_route()
        native["jpeg_route"] = route[0]
        from waymo_2d_tracking_tpu_torch.data.jpeg import BatchJpegDecoder

        BatchJpegDecoder(8, 8).close()     # builds, loads and checks the probe JPEG
        native["jpeg_decoder"] = True
    except Exception as e:  # a report: what is missing is the finding
        native["jpeg_decoder"] = False
        native["jpeg_error"] = f"{type(e).__name__}: {e}"[:300]
    try:
        from waymo_2d_tracking_tpu_torch.data import tfrecord_native

        tfrecord_native._load()
        native["tfrecord_scanner"] = True
    except Exception as e:
        native["tfrecord_scanner"] = False
        native["tfrecord_error"] = f"{type(e).__name__}: {e}"[:300]
    report["native"] = native
    report["optional_deps"] = {}
    for mod in ("numpy", "scipy", "yaml", "cv2", "PIL", "triton"):
        try:
            m = importlib.import_module(mod)
            report["optional_deps"][mod] = getattr(m, "__version__", "ok")
        except ImportError:
            report["optional_deps"][mod] = None
    preset_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                              "configs")
    report["presets"] = (sorted(f[:-5] for f in os.listdir(preset_dir) if f.endswith(".yaml"))
                         if os.path.isdir(preset_dir) else [])
    ok = torch.cuda.is_available() and torch.cuda.device_count() > 0
    report["status"] = "ok" if ok else "degraded"
    print(json.dumps(report, indent=2))
    return 0 if ok else 1


def cmd_bench(args):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(root, "benchmark", "run.py")
    if not os.path.isfile(script):
        sys.exit(f"bench: {script} is missing: the benchmark runs from a checkout of the "
                 "repository")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    sys.stdout.flush()
    os.chdir(root)
    os.execve(sys.executable, [sys.executable, script] + args.bench_args, env)


def build_parser():
    p = argparse.ArgumentParser(prog="w2t-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp):
        sp.add_argument("--config", default=None, help="yaml (or .json) preset path")
        sp.add_argument("--set", nargs="*", help="dotted overrides key=value")
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--params", default=None,
                        help="weights: flax .npz, port state dict or training checkpoint")
        sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the verb computes (default cuda; raises without a card)")
        sp.add_argument("--profile", default=None,
                        help="torch.profiler Chrome trace and the port's counters, output dir")
        sp.add_argument("--compile-cache", dest="compile_cache", default=None,
                        metavar="DIR|off",
                        help="where the CUDA kernels are built and found (default "
                             "$W2T_COMPILE_CACHE or the package's _build/; 'off': a "
                             "temporary directory)")

    sp = sub.add_parser("track", help="detect+track segments -> track files")
    common(sp)
    sp.add_argument("--segments-dir")
    sp.add_argument("--out-dir", default="out")
    sp.add_argument("--from-detections", help="JSONL detections (config-1 path)")
    sp.add_argument("--multicam", action="store_true",
                    help="shared-backbone multi-camera batching (config 4)")
    sp.add_argument("--sharded", action="store_true",
                    help="fan segments (or --multicam contexts) across the ranks, one a rank")
    sp.add_argument("--online", action="store_true",
                    help="streaming path: one frame per device step; stats report "
                         "p50/p90/p99 serving latency")
    sp.add_argument("--video", default=None,
                    help="stream a video file through the online path (implies "
                         "--online; needs OpenCV)")
    sp.add_argument("--out", default="tracks.jsonl")
    sp.add_argument("--fail-after-n-segments", type=int, default=None)
    sp.set_defaults(fn=cmd_track)

    sp = sub.add_parser("detect", help="detection-only inference")
    common(sp)
    sp.add_argument("--segments-dir", required=True)
    sp.add_argument("--out", default="detections.jsonl")
    sp.add_argument("--sharded", action="store_true",
                    help="fan segments across the ranks (stateless), merged into --out")
    sp.add_argument("--out-dir", default=None,
                    help="per-segment output dir for --sharded (default <out>.d)")
    sp.set_defaults(fn=cmd_detect)

    sp = sub.add_parser("submit", help="JSONL -> Waymo submission pb")
    sp.add_argument("inputs", nargs="+")
    sp.add_argument("--out", default="submission.pb")
    sp.set_defaults(fn=cmd_submit)

    sp = sub.add_parser("export", aliases=["export-savedmodel"],
                        help="detector -> torch.export program (.pt2) + JSON sidecar")
    common(sp)
    sp.add_argument("--out", required=True, help="program output path (.pt2)")
    sp.add_argument("--batch", type=int, default=1,
                    help="static batch size baked into the program")
    sp.add_argument("--platform", choices=("cpu", "cuda"), default=None,
                    help="cuda: the NMS kernel; cpu: its plain version (default: --device)")
    sp.set_defaults(fn=cmd_export)

    sp = sub.add_parser("import-mot",
                        help="MOTChallenge txt (gt/det/results) -> TrackRecord JSONL")
    sp.add_argument("input", help=".txt file, or a directory (<seq>.txt or <seq>/gt/gt.txt)")
    sp.add_argument("--out", required=True)
    sp.add_argument("--gt", action="store_true",
                    help="ground-truth semantics: consider flag and class column")
    sp.add_argument("--camera", type=int, default=1, help="camera_name to stamp")
    sp.add_argument("--context", default=None,
                    help="sequence/context name for a single-file input")
    sp.set_defaults(fn=cmd_import_mot)

    sp = sub.add_parser("export-mot",
                        help="TrackRecord JSONL -> MOTChallenge result files per sequence")
    sp.add_argument("inputs", nargs="+")
    sp.add_argument("--out-dir", required=True)
    sp.set_defaults(fn=cmd_export_mot)

    sp = sub.add_parser("interp", help="fill short per-track gaps in a track JSONL")
    sp.add_argument("input")
    sp.add_argument("--out", required=True)
    sp.add_argument("--max-gap", type=int, default=5,
                    help="largest run of missing frames to fill")
    sp.set_defaults(fn=cmd_interp)

    sp = sub.add_parser("eval", help="MOTA/MOTP vs ground truth")
    sp.add_argument("--pred", required=True)
    sp.add_argument("--gt", required=True)
    sp.add_argument("--iou", type=float, default=0.5)
    sp.add_argument("--ignore", default=None,
                    help="don't-care regions JSONL (import-mot --gt's .ignore.jsonl)")
    sp.add_argument("--hota", action="store_true", help="also HOTA/DetA/AssA/LocA")
    sp.add_argument("--per-class", action="store_true", dest="per_class",
                    help="also pooled metrics per Waymo object type")
    sp.add_argument("--workers", type=int, default=0,
                    help="process-pool size for per-(context,camera) evaluation")
    sp.set_defaults(fn=cmd_eval)

    sp = sub.add_parser("tune", help="tracker hyperparameter random search over "
                                     "precomputed detections, scored vs ground truth")
    common(sp)
    sp.add_argument("--from-detections", required=True, dest="from_detections",
                    help="detections JSONL (detect output)")
    sp.add_argument("--gt", required=True, help="ground-truth JSONL")
    sp.add_argument("--trials", type=int, default=20)
    sp.add_argument("--objective", choices=("mota", "idf1", "motp"), default="mota")
    sp.add_argument("--iou", type=float, default=0.5, help="evaluation IoU threshold")
    sp.add_argument("--workers", type=int, default=0,
                    help="trial process-pool size (spawned, each on --device); 0/1 = serial")
    sp.add_argument("--out", default=None, help="write the full ranked trial report JSON here")
    sp.set_defaults(fn=cmd_tune)

    sp = sub.add_parser("eval-det", help="COCO-style detection AP (mAP/AP50/AP75) vs GT")
    sp.add_argument("--pred", required=True, help="detections JSONL")
    sp.add_argument("--gt", required=True, help="GT labels JSONL")
    sp.add_argument("--num-classes", type=int, default=3)
    sp.set_defaults(fn=cmd_eval_det)

    sp = sub.add_parser("train", help="train the detector")
    common(sp)
    sp.add_argument("--data-dir", default=None, help="COCO-converted data")
    sp.add_argument("--steps", type=int, default=None)
    sp.add_argument("--sharded", action="store_true",
                    help="data parallel over the ranks (W2T_* variables; else a world of one)")
    sp.add_argument("--val-every", type=int, default=0, dest="val_every",
                    help="held-out detection-AP validation every N steps (0 disables)")
    sp.add_argument("--val-dir", default=None, dest="val_dir",
                    help="COCO-converted validation data (default: held-out synthetic)")
    sp.add_argument("--val-batches", type=int, default=4, dest="val_batches")
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("link", help="unify track ids across cameras of a context")
    sp.add_argument("--out-dir", required=True,
                    help="track output dir (with .gallery.npz sidecars)")
    sp.add_argument("--linked-dir", default=None)
    sp.add_argument("--threshold", type=float, default=0.6)
    sp.add_argument("--sharded", action="store_true",
                    help="score through the ring-sharded gallery over the ranks")
    sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where --sharded scores (default cuda)")
    sp.set_defaults(fn=cmd_link)

    sp = sub.add_parser("draw", help="render track boxes onto frames (debug; OpenCV)")
    common(sp)
    sp.add_argument("--tracks", required=True, help="tracks JSONL")
    sp.add_argument("--segments-dir", required=True)
    sp.add_argument("--out-dir", default="viz")
    sp.add_argument("--max-frames", type=int, default=None)
    sp.add_argument("--video", default=None, help="also encode the frames to this video")
    sp.add_argument("--fps", type=float, default=10.0, help="video frame rate")
    sp.set_defaults(fn=cmd_draw)

    sp = sub.add_parser("import-weights",
                        help="torchvision .pth checkpoint -> the port's state dict")
    common(sp)
    sp.add_argument("ckpt", help="torch state-dict checkpoint (.pth)")
    sp.add_argument("--out", required=True, help="state dict output path")
    sp.add_argument("--verbose", action="store_true", help="print the per-key report")
    sp.set_defaults(fn=cmd_import_weights)

    sp = sub.add_parser("convert", help="Waymo segments -> COCO detection data")
    sp.add_argument("--segments-dir", required=True)
    sp.add_argument("--out-dir", required=True)
    sp.set_defaults(fn=cmd_convert)

    sp = sub.add_parser("serve",
                        help="serving daemon: the online tracker behind a local socket")
    common(sp)
    sp.add_argument("--socket", default=None, help="AF_UNIX socket path")
    sp.add_argument("--port", type=int, default=None, help="localhost TCP port (0 = ephemeral)")
    sp.add_argument("--camera", type=int, default=1)
    sp.add_argument("--multicam", action="store_true",
                    help="serve a whole camera rig per frame message")
    sp.add_argument("--warmup", nargs=2, metavar=("H", "W"), default=None,
                    help="build the kernels and capture the tracker step for H W "
                         "sources before accepting")
    sp.add_argument("--state-file", default=None, dest="state_file",
                    help="restore the tracker state from this file at start (if present) "
                         "and write it atomically on exit")
    sp.add_argument("--max-requests", type=int, default=None,
                    help="exit after N requests (drain/test hook)")
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("doctor", help="environment health report (card, kernels, deps)")
    sp.add_argument("--compile-cache", dest="compile_cache", default=None, metavar="DIR|off")
    sp.set_defaults(fn=cmd_doctor)

    # a prefix no argument of benchmark/run.py starts with: every argument,
    # its flags and -h included, lands in the remainder as given
    sp = sub.add_parser("bench", prefix_chars="+", add_help=False,
                        help="run the port's benchmark (benchmark/run.py)")
    sp.add_argument("bench_args", nargs=argparse.REMAINDER,
                    help="benchmark/run.py's arguments, passed on unchanged")
    sp.set_defaults(fn=cmd_bench)
    return p


def main(argv: Optional[List[str]] = None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
