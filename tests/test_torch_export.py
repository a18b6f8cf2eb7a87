"""The port's exported detect program (``io_out/export.py``, ``export``):
the CPU artifact, reloaded, equals ``DetectorRunner`` through
``dispatch_detect`` on the same images (the plain, TTA and CenterNet
presets), and the JAX package's detect step on the same weights."""
import json

import jax
import numpy as np
import pytest
import torch

from waymo_2d_tracking_tpu.config import load_config as jax_load_config
from waymo_2d_tracking_tpu.io_out import export_tf as jexport
from waymo_2d_tracking_tpu.models.detector import DetectorRunner as JaxRunner

from waymo_2d_tracking_tpu_torch import cli
from waymo_2d_tracking_tpu_torch.config import load_config
from waymo_2d_tracking_tpu_torch.io_out import export
from waymo_2d_tracking_tpu_torch.models.detector import DetectorRunner
from waymo_2d_tracking_tpu_torch.pipeline.run import dispatch_detect
from waymo_2d_tracking_tpu_torch.weights import from_flax_numpy

torch.set_num_threads(1)

DET = {"backbone": "resnet18slim", "image_size": [64, 96], "fpn_channels": 32,
       "head_depth": 1, "pre_nms_topk": 32, "max_detections": 8, "embed_dim": 16,
       "dtype": "float32", "score_threshold": 0.01}
PRESETS = {
    "plain": {"detector": DET},
    "tta": {"detector": DET, "pipeline": {"tta_flip": True}},
    "centernet": {"detector": {**DET, "head_family": "centernet", "embed_dim": 0}},
}


def _images(b=2):
    return np.random.default_rng(0).uniform(0, 255, (b, 64, 96, 3)).astype(np.float32)


def _weights(overrides):
    jcfg = jax_load_config(None, overrides)
    params = JaxRunner(jcfg.detector).init_params(jax.random.PRNGKey(1), batch_size=1)
    return jcfg, params, from_flax_numpy(jax.tree.map(np.asarray, jax.device_get(params)))


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_cpu_artifact_equals_the_runner(tmp_path, name):
    overrides = PRESETS[name]
    jcfg, params, sd = _weights(overrides)
    cfg = load_config(None, overrides)
    out = str(tmp_path / "det.pt2")
    info = export.export_program(cfg, sd, out, batch_size=2, platform="cpu")
    side = json.load(open(out + ".json"))
    assert side == info and side["input"] == {"shape": [2, 64, 96, 3], "dtype": "float32"}
    assert (side["tta"] is not None) == (name == "tta")
    images = _images()
    got = export.load_and_run(out, images)
    want = dispatch_detect(DetectorRunner(cfg.detector, sd, device="cpu"), cfg,
                           torch.as_tensor(images))
    assert want.valid.any()
    for k in export.OUTPUTS:
        np.testing.assert_array_equal(got[k], getattr(want, k).numpy(), err_msg=k)
    # the graph holds the NMS as one operator node, not its unrolled loop
    ep = torch.export.load(out)
    assert [str(n.target) for n in ep.graph.nodes if "nms" in str(n.target)] == ["w2t.nms_mask.default"]
    if name == "plain":
        # the JAX package's detect step (interpret-path kernels) on the same weights
        fn, _ = jexport.make_detect_fn(jcfg, params, "cpu")
        ref = jax.device_get(jax.jit(fn)(images))
        np.testing.assert_array_equal(got["valid"], np.asarray(ref["valid"]))
        np.testing.assert_array_equal(got["classes"], np.asarray(ref["classes"]))
        np.testing.assert_allclose(got["boxes"], np.asarray(ref["boxes"]), atol=0.2)
        np.testing.assert_allclose(got["scores"], np.asarray(ref["scores"]), atol=1e-4)
        np.testing.assert_allclose(got["embeds"], np.asarray(ref["embeds"]), atol=1e-3)


def test_export_cli_and_platform_checks(tmp_path, capsys):
    """``export`` (and its alias ``export-savedmodel``) prints the sidecar; an
    unknown platform and an uncalibrated int8 detector are refused."""
    out = str(tmp_path / "c.pt2")
    cli.main(["export-savedmodel", "--out", out, "--batch", "1", "--device", "cpu", "--set",
              "detector.backbone=resnet18slim", "detector.image_size=[64,96]",
              "detector.fpn_channels=32", "detector.head_depth=1", "detector.embed_dim=0",
              "detector.dtype=float32"])
    info = json.loads(capsys.readouterr().out)
    assert info["platform"] == "cpu" and info["batch_size"] == 1
    assert export.load_and_run(out, _images(1))["boxes"].shape == (1, 128, 4)
    cfg = load_config(None, PRESETS["plain"])
    with pytest.raises(ValueError, match="platform"):
        export.make_detect_fn(cfg, None, "tpu")
    int8 = load_config(None, {"detector": {**DET, "quant": "int8"}})
    with pytest.raises(RuntimeError, match="calibrat"):
        export.export_program(int8, None, str(tmp_path / "q.pt2"), platform="cpu")
