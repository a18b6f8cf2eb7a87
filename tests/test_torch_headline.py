"""The headline architecture (``configs/headline.yaml``: ResNet-18 with the
s2d stem, 128-wide FPN over P3-P6, 2-deep 128-wide FCOS towers, 128-wide
ReID) against the JAX package at a small input, float32 on the CPU.

The trained fixtures are ResNet18Slim over P3-P5, so this is what holds the
BasicBlock backbone, the P6 level and ``weights.from_flax_numpy`` on a
ResNet-18 tree to the reference: JAX draws the variables from a seed, the
port loads them converted. Tolerances as in ``test_torch_detector.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from waymo_2d_tracking_tpu.config import DetectorConfig as JaxDetectorConfig
from waymo_2d_tracking_tpu.models.detector import DetectorRunner as JaxRunner

from waymo_2d_tracking_tpu_torch.config import Config, _update
from waymo_2d_tracking_tpu_torch.models.detector import DetectorRunner
from waymo_2d_tracking_tpu_torch.weights import from_flax_numpy

from test_torch_isolation import _chip_smoke

# xdist runs several workers on the machine's cores; a torch thread pool the
# width of the machine in each would oversubscribe them, and the port's CPU
# ops are small, so one thread each is fastest.
torch.set_num_threads(1)


def test_headline_detector_matches_jax_at_small_input():
    headline = _update(Config(), _chip_smoke().HEADLINE).detector
    # a small input and float32; every width stays the headline's. A low
    # score threshold lets random weights produce detections.
    cfg = dataclasses.replace(headline, image_size=(96, 128), dtype="float32",
                              score_threshold=0.01)
    jcfg = JaxDetectorConfig(**dataclasses.asdict(cfg))
    jrunner = JaxRunner(jcfg)
    variables = jrunner.init_params(jax.random.PRNGKey(0), batch_size=1)
    variables = jax.tree.map(lambda x: np.asarray(x), jax.device_get(variables))
    runner = DetectorRunner(cfg, from_flax_numpy(variables), device="cpu")

    rng = np.random.default_rng(0)
    images = rng.normal(size=(2, 96, 128, 3)).astype(np.float32)
    jhead, _ = jrunner.module.apply(variables, jnp.asarray(images))
    head, _ = runner.forward(torch.from_numpy(images))
    assert sorted(head) == [3, 4, 5, 6]
    for lvl in cfg.fpn_levels:
        for got, want in zip(head[lvl], jhead[lvl]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                                       rtol=1e-4, atol=1e-4, err_msg=f"P{lvl}")

    want = jax.device_get(jrunner.detect(variables, jnp.asarray(images)))
    got = runner.detect(torch.from_numpy(images)).to_numpy()
    np.testing.assert_array_equal(got.valid, want.valid)
    assert got.valid.any() and got.embeds.shape == (2, 64, 128)
    np.testing.assert_array_equal(got.classes, want.classes)
    np.testing.assert_allclose(got.boxes, want.boxes, atol=1e-3)
    np.testing.assert_allclose(got.scores, want.scores, atol=1e-5)
    np.testing.assert_allclose(got.embeds, want.embeds, atol=1e-4)
