"""The port stands alone: it imports neither JAX, flax, orbax, the JAX package
nor cv2 (``data/video.py`` and ``utils/viz.py`` load cv2 on demand), its
config copy cannot drift from the JAX one, ``chip_smoke.py``'s preset dicts
are ``configs/headline.yaml``, ``configs/headline_centernet.yaml`` and
``configs/config4_multicam.yaml``, and nothing falls back to the CPU on its
own."""
import ast
import dataclasses
import importlib.util
import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import waymo_2d_tracking_tpu.config as jax_config
import waymo_2d_tracking_tpu_torch
from waymo_2d_tracking_tpu_torch import config as port_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(waymo_2d_tracking_tpu_torch.__file__)


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([PKG_DIR], "waymo_2d_tracking_tpu_torch.")
    )


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_imports_no_jax_in_a_fresh_process():
    mods = ["waymo_2d_tracking_tpu_torch"] + _port_modules()
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "importlib.import_module('chip_smoke')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'orbax', 'waymo_2d_tracking_tpu', 'cv2'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert len(mods) >= 30
    for new in ("pipeline.multicam", "pipeline.online", "pipeline.offline", "pipeline.link",
                "pipeline.manifest", "io_out.postprocess", "data.prefetch", "tracker.graph",
                "models.quant", "data._native", "data.jpeg", "data.tfrecord_native",
                "data.waymo", "utils.protolite", "train.losses", "train.train", "eval.ap",
                "data.coco", "cli", "pipeline.server", "pipeline.tune", "io_out.export",
                "data.video", "utils.profiling", "utils.compile_cache", "eval.hota",
                "io_out.motchallenge", "utils.viz", "train.port_torch", "parallel.sharding",
                "parallel.multihost", "parallel.ring", "parallel.collectives", "parallel.launch",
                "pipeline.sharded"):
        assert f"waymo_2d_tracking_tpu_torch.{new}" in mods, new


def test_sources_never_name_the_jax_package():
    pattern = re.compile(r"waymo_2d_tracking_tpu(?!_torch)")
    hits = []
    for dirpath, _, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    for n, line in enumerate(fh, 1):
                        if pattern.search(line):
                            hits.append(f"{path}:{n}: {line.strip()}")
    assert not hits, hits
    sources = [os.path.join(ROOT, "chip_smoke.py")] + [
        os.path.join(dirpath, f) for dirpath, _, files in os.walk(PKG_DIR)
        for f in files if f.endswith(".py")]
    for path in sources:
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "orbax", "cv2",
                                                  "waymo_2d_tracking_tpu"), (path, name)


def _fields(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        elif f.default_factory is not dataclasses.MISSING:
            out[f.name] = dataclasses.asdict(f.default_factory())
        else:
            out[f.name] = dataclasses.MISSING
    return out


@pytest.mark.parametrize("name", ["KalmanConfig", "TrackerConfig", "DetectorConfig",
                                  "PipelineConfig", "TrainConfig", "Config"])
def test_config_copy_equals_jax(name):
    assert _fields(getattr(port_config, name)) == _fields(getattr(jax_config, name))


def test_headline_dict_equals_yaml():
    smoke = _chip_smoke()
    got = port_config._update(port_config.Config(), smoke.HEADLINE)
    want = jax_config.load_config(os.path.join(ROOT, "configs", "headline.yaml"))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(port_config.load_config(
        os.path.join(ROOT, "configs", "headline.yaml"))) == dataclasses.asdict(want)


def test_entry_points_need_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from waymo_2d_tracking_tpu_torch.config import Config, TrackerConfig
    from waymo_2d_tracking_tpu_torch.data.prefetch import DevicePrefetcher, prefetch_to_device
    from waymo_2d_tracking_tpu_torch.models.detector import DetectorRunner
    from waymo_2d_tracking_tpu_torch.ops.assign import auction_kernel_cuda
    from waymo_2d_tracking_tpu_torch.ops.nms import nms_mask_cuda
    from waymo_2d_tracking_tpu_torch.ops.roi_align import roi_align_cuda
    from waymo_2d_tracking_tpu_torch.ops.topk import topk_threshold_cuda
    from waymo_2d_tracking_tpu_torch.pipeline.multicam import MultiCamPipeline
    from waymo_2d_tracking_tpu_torch.pipeline.offline import track_detection_rows
    from waymo_2d_tracking_tpu_torch.pipeline.online import OnlineMultiCamTracker, OnlineTracker
    from waymo_2d_tracking_tpu_torch.pipeline.run import SegmentPipeline
    from waymo_2d_tracking_tpu_torch.tracker import Tracker, init_multicam_state, init_state
    from waymo_2d_tracking_tpu_torch.tracker.graph import CapturedTracker
    from waymo_2d_tracking_tpu_torch.types import Detections
    from waymo_2d_tracking_tpu_torch.data.coco import coco_batch_iterator
    from waymo_2d_tracking_tpu_torch.train.train import DetectorTrainer

    small = dict(backbone="resnet18slim", image_size=(64, 64), fpn_channels=32,
                 fpn_levels=(3, 4, 5), head_depth=1, head_channels=32, embed_dim=0)
    cfg = port_config._update(Config(), {"detector": small, "tracker": {"embed_dim": 0}})
    for make in (lambda: Tracker(TrackerConfig()), lambda: init_state(TrackerConfig()),
                 lambda: DetectorRunner(cfg.detector), lambda: SegmentPipeline(cfg),
                 lambda: MultiCamPipeline(cfg, num_cams=2), lambda: init_multicam_state(cfg, 2),
                 lambda: OnlineTracker(cfg), lambda: OnlineMultiCamTracker(cfg, [1, 2]),
                 lambda: track_detection_rows(cfg, []), lambda: DevicePrefetcher([]),
                 lambda: prefetch_to_device([]), lambda: DetectorTrainer(cfg),
                 lambda: next(coco_batch_iterator(ROOT, 2, (32, 48)))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    Tracker(TrackerConfig(), device="cpu").init()
    SegmentPipeline(cfg, device="cpu")
    MultiCamPipeline(cfg, num_cams=2, device="cpu")
    assert tuple(init_multicam_state(cfg, 2, device="cpu").next_id.shape) == (2,)
    OnlineTracker(cfg, device="cpu")
    OnlineMultiCamTracker(cfg, [1, 2], device="cpu")
    assert list(DevicePrefetcher([], device="cpu")) == []
    assert DetectorTrainer(cfg, device="cpu").device.type == "cpu"
    # the captured tracker step exists only on the card
    state = init_state(TrackerConfig(), device="cpu")
    det = Detections(boxes=torch.zeros(64, 4), scores=torch.zeros(64),
                     classes=torch.zeros(64, dtype=torch.int32), embeds=torch.zeros(64, 128),
                     valid=torch.zeros(64, dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA"):
        CapturedTracker(TrackerConfig(), state, det)
    # the kernel wrappers never run their plain versions for a CPU tensor
    with pytest.raises(ValueError, match="CUDA"):
        nms_mask_cuda(torch.zeros(1, 4, 4), torch.ones(1, 4, dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA"):
        auction_kernel_cuda(torch.zeros(1, 64, 64), torch.ones(1), torch.ones(1, dtype=torch.bool),
                            eps_scale=0.2, eps_min=1e-2, max_iters=10)
    with pytest.raises(ValueError, match="CUDA"):
        roi_align_cuda(torch.zeros(1, 4, 4, 8), torch.zeros(1, 2, 4))
    with pytest.raises(ValueError, match="CUDA"):
        topk_threshold_cuda(torch.zeros(1, 16), 4)


def test_later_slices_raise_not_implemented():
    """The mesh-sharded gallery scoring refuses a ``mesh`` that is not a
    ``DeviceMesh`` (it runs in ``tests/test_torch_parallel.py``); int8, JPEG
    frames (malformed bytes raise a ValueError, not NotImplementedError), the
    CenterNet head family, TTA and output gap interpolation are ported and
    build on the CPU."""
    from waymo_2d_tracking_tpu_torch.config import Config
    from waymo_2d_tracking_tpu_torch.models.centernet import CenterNetHeads
    from waymo_2d_tracking_tpu_torch.models.detector import Detector
    from waymo_2d_tracking_tpu_torch.models.quant import QuantConv2d
    from waymo_2d_tracking_tpu_torch.pipeline.link import best_cross_camera_matches
    from waymo_2d_tracking_tpu_torch.pipeline.online import OnlineTracker
    from waymo_2d_tracking_tpu_torch.pipeline.run import SegmentPipeline, tta_active

    base = Config()
    with pytest.raises(TypeError, match="DeviceMesh"):
        best_cross_camera_matches({}, mesh=object())
    small = {"backbone": "resnet18slim", "image_size": [64, 64], "fpn_channels": 32,
             "fpn_levels": [3, 4, 5], "head_depth": 1, "embed_dim": 0}
    interp = port_config._update(base, {"detector": small, "pipeline": {"interp_max_gap": 2}})
    SegmentPipeline(interp, device="cpu")
    int8 = Detector(port_config._update(base, {"detector": {**small, "quant": "int8"}}).detector)
    assert isinstance(int8.backbone.stem_conv, QuantConv2d)
    with pytest.raises(ValueError, match="JPEG"):
        OnlineTracker(interp, device="cpu").step(b"\xff\xd8\xff", 0)
    centernet = {**small, "head_family": "centernet"}
    assert isinstance(Detector(port_config._update(base, {"detector": centernet}).detector)
                      .heads, CenterNetHeads)
    for overrides in ({"pipeline": {"tta_flip": True}}, {"pipeline": {"tta_scales": [1.0, 0.75]}},
                      {"pipeline": {"tta_flip": True}, "detector": centernet}):
        cfg = port_config._update(base, {"detector": small, **overrides})
        assert tta_active(cfg.pipeline)
        SegmentPipeline(cfg, device="cpu")


def test_headline_int8_dict_equals_yaml():
    """``chip_smoke.HEADLINE_INT8`` is ``configs/headline_int8.yaml`` loaded
    into the port's Config, field for field."""
    smoke = _chip_smoke()
    got = port_config._update(port_config.Config(), smoke.HEADLINE_INT8)
    want = jax_config.load_config(os.path.join(ROOT, "configs", "headline_int8.yaml"))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.detector.quant == "int8" and got.detector.quant_scope == "trunk"
    assert got.pipeline.decode_scale_denom == 2


def test_headline_centernet_dict_equals_yaml():
    smoke = _chip_smoke()
    got = port_config._update(port_config.Config(), smoke.HEADLINE_CENTERNET)
    want = jax_config.load_config(os.path.join(ROOT, "configs", "headline_centernet.yaml"))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_config4_dict_equals_yaml():
    smoke = _chip_smoke()
    got = port_config._update(port_config.Config(), smoke.CONFIG4)
    want = jax_config.load_config(os.path.join(ROOT, "configs", "config4_multicam.yaml"))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.tracker.max_tracks, got.tracker.max_detections, got.pipeline.chunk_frames,
            len(got.pipeline.cameras)) == (128, 128, 8, 5)
