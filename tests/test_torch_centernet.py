"""The port's CenterNet head family against the JAX package: peak extraction,
the peak top-k decode, and a whole CenterNet detector (JAX init variables
carried over by ``weights.from_flax_numpy``), float32 on the CPU.

Tolerances as in ``test_torch_detector.py``: raw head outputs rtol/atol 1e-4
(convolutions sum in another order), boxes 1e-3 px, scores 1e-5, embeddings
1e-4; peaks, candidate indices, valid and classes are exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waymo_2d_tracking_tpu.config import DetectorConfig as JaxDetectorConfig
from waymo_2d_tracking_tpu.models.centernet import (
    gather_centernet_candidates_batched as jax_gather,
)
from waymo_2d_tracking_tpu.models.centernet import heat_peaks as jax_heat_peaks
from waymo_2d_tracking_tpu.models.detector import DetectorRunner as JaxRunner

from waymo_2d_tracking_tpu_torch.config import Config, DetectorConfig, _update
from waymo_2d_tracking_tpu_torch.models.centernet import (
    gather_centernet_candidates_batched,
    heat_peaks,
)
from waymo_2d_tracking_tpu_torch.models.detector import DetectorRunner
from waymo_2d_tracking_tpu_torch.weights import from_flax_numpy

from test_torch_isolation import _chip_smoke

# xdist runs several workers on the machine's cores; a torch thread pool the
# width of the machine in each would oversubscribe them, and the port's CPU
# ops are small, so one thread each is fastest.
torch.set_num_threads(1)

SMALL = dict(
    backbone="resnet18slim", image_size=(64, 96), fpn_channels=32,
    fpn_levels=(3, 4, 5), head_family="centernet", centernet_level=3,
    head_depth=1, head_channels=32, pre_nms_topk=64, nms_topk=128,
    max_detections=16, embed_dim=16, dtype="float32", score_threshold=0.001,
)


def _head_out(seed, n=2, h=9, w=13, k=3):
    """Random CenterNet head outputs; coarse heat values make equal
    neighbours (ties between peaks) common."""
    rng = np.random.default_rng(seed)
    heat = (np.round(rng.normal(0, 1.5, (n, h, w, k)) * 2) / 2).astype(np.float32)
    wh = rng.normal(0, 0.5, (n, h, w, 2)).astype(np.float32)
    off = rng.uniform(-0.5, 0.5, (n, h, w, 2)).astype(np.float32)
    return heat, wh, off


@pytest.mark.parametrize("seed", [0, 1])
def test_heat_peaks_match_jax(seed):
    heat, _, _ = _head_out(seed)
    prob = jax.nn.sigmoid(jnp.asarray(heat))
    want = np.asarray(jax_heat_peaks(prob))
    got = heat_peaks(torch.sigmoid(torch.from_numpy(heat))).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert (want > 0).sum() > 0


@pytest.mark.parametrize("seed,topk", [(0, 40), (1, 200), (2, 1000)])
def test_centernet_candidates_match_jax(seed, topk):
    heat, wh, off = _head_out(seed)
    cfg = DetectorConfig(**{**SMALL, "pre_nms_topk": topk})
    jcfg = JaxDetectorConfig(**{**SMALL, "pre_nms_topk": topk})
    want = jax_gather({3: tuple(jnp.asarray(t) for t in (heat, wh, off))}, jcfg)
    got = gather_centernet_candidates_batched(
        {3: tuple(torch.from_numpy(t) for t in (heat, wh, off))}, cfg)
    boxes, scores, classes = (np.asarray(t) for t in want)
    assert got[0].shape == boxes.shape == (2, min(topk, 9 * 13 * 3), 4)
    np.testing.assert_array_equal(got[2].numpy(), classes)
    np.testing.assert_allclose(got[1].numpy(), scores, rtol=1e-6)
    np.testing.assert_allclose(got[0].numpy(), boxes, rtol=1e-5, atol=1e-4)


def _detector_pair(cfg):
    jcfg = JaxDetectorConfig(**dataclasses.asdict(cfg))
    jrunner = JaxRunner(jcfg)
    variables = jrunner.init_params(jax.random.PRNGKey(0), batch_size=1)
    variables = jax.tree.map(np.asarray, jax.device_get(variables))
    return jrunner, variables, DetectorRunner(cfg, from_flax_numpy(variables), device="cpu")


@pytest.mark.parametrize("which", ["small", "headline_centernet"])
def test_centernet_detector_matches_jax(which):
    if which == "small":
        cfg = DetectorConfig(**SMALL)
        hw = SMALL["image_size"]
    else:
        # every width of configs/headline_centernet.yaml, at a small input
        # and in float32; a low threshold lets random weights detect
        cfg = dataclasses.replace(
            _update(Config(), _chip_smoke().HEADLINE_CENTERNET).detector,
            image_size=(96, 128), dtype="float32", score_threshold=0.001)
        hw = (96, 128)
    jrunner, variables, runner = _detector_pair(cfg)
    assert sorted(runner.module.state_dict()) == sorted(from_flax_numpy(variables))
    rng = np.random.default_rng(0)
    images = rng.normal(size=(2,) + tuple(hw) + (3,)).astype(np.float32)

    jhead, _ = jrunner.module.apply(variables, jnp.asarray(images))
    head, _ = runner.forward(torch.from_numpy(images))
    assert sorted(head) == sorted(jhead) == [cfg.centernet_level]
    for got, want in zip(head[3], jhead[3]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                                   rtol=1e-4, atol=1e-4)

    want = jax.device_get(jrunner.detect(variables, jnp.asarray(images)))
    got = runner.detect(torch.from_numpy(images)).to_numpy()
    np.testing.assert_array_equal(got.valid, want.valid)
    assert got.valid.any()
    np.testing.assert_array_equal(got.classes, want.classes)
    np.testing.assert_allclose(got.boxes, want.boxes, atol=1e-3)
    np.testing.assert_allclose(got.scores, want.scores, atol=1e-5)
    np.testing.assert_allclose(got.embeds, want.embeds, atol=1e-4)


def test_random_init_sets_the_heat_prior():
    runner = DetectorRunner(DetectorConfig(**SMALL), device="cpu", seed=3)
    heads = runner.module.heads
    assert torch.all(heads.heat.bias == -4.595)
    assert torch.all(heads.wh.bias == 0) and torch.all(heads.offset.bias == 0)
