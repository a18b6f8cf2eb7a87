"""The port's RoIAlign against the JAX package.

- ``roi_align_kernel_reference`` (the plain version of ``csrc/roi_align.cu``)
  vs the Pallas ``_roi_align_kernel`` in interpret mode, atol 1e-5: the same
  f32 arithmetic, where XLA may order the window sum's zero terms otherwise;
  one map has H >= 32, so that the Pallas kernel's 32-row window branch runs.
- the single-image matmul form ``roi_align`` / ``roi_align_multilevel`` vs
  JAX, atol 1e-5 (matrix products sum in another order);
- the kernel's plain version vs the matmul form, atol 1e-4 (the separable
  products sum the same terms in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waymo_2d_tracking_tpu.ops.roi_align import pallas_roi_align
from waymo_2d_tracking_tpu.ops.roi_align import roi_align as jax_roi_align
from waymo_2d_tracking_tpu.ops.roi_align import roi_align_multilevel as jax_multilevel

from waymo_2d_tracking_tpu_torch.ops.roi_align import (
    roi_align,
    roi_align_batched,
    roi_align_cuda,
    roi_align_kernel,
    roi_align_kernel_reference,
    roi_align_multilevel,
)

# xdist runs several workers on the machine's cores; a torch thread pool the
# width of the machine in each would oversubscribe them, and the port's CPU
# ops are small, so one thread each is fastest.
torch.set_num_threads(1)

# tests/unit/test_roi_align.py:109-130
BOXES = np.array([[4.0, 4.0, 60.0, 44.0], [0.0, 0.0, 96.0, 64.0],
                  [-8.0, -8.0, 30.0, 30.0], [50.0, 30.0, 70.0, 44.0]], np.float32)


def _case(name):
    rng = np.random.default_rng(3)
    if name == "unit_test_16x24":
        return rng.normal(0, 1, (16, 24, 8)).astype(np.float32), BOXES, 0.25, 7, 2
    if name == "window_40x36":       # H >= 32: the Pallas 32-row window branch
        feats = rng.normal(0, 1, (40, 36, 4)).astype(np.float32)
        xy = rng.uniform(-20, 300, (6, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(4, 200, (6, 2))], 1)
        return feats, boxes.astype(np.float32), 1 / 8, 7, 2
    if name == "h2_s3":              # the smallest map the kernel takes, sampling 3
        feats = rng.normal(0, 1, (2, 5, 3)).astype(np.float32)
        boxes = np.array([[0.0, 0.0, 20.0, 8.0], [-6.0, -2.0, 3.0, 12.0]], np.float32)
        return feats, boxes, 0.25, 4, 3
    raise KeyError(name)


CASES = ["unit_test_16x24", "window_40x36", "h2_s3"]


@pytest.mark.parametrize("case", CASES)
def test_kernel_reference_matches_pallas(case):
    feats, boxes, scale, p, s = _case(case)
    want = np.asarray(pallas_roi_align(jnp.asarray(feats), jnp.asarray(boxes), spatial_scale=scale,
                                       output_size=p, sampling_ratio=s, interpret=True))
    got = roi_align_kernel(torch.from_numpy(feats), torch.from_numpy(boxes), scale, p, s)
    assert got.shape == (len(boxes), p, p, feats.shape[-1]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # the plain version against the matmul form of the same function
    mm = roi_align(torch.from_numpy(feats), torch.from_numpy(boxes), scale, p, s)
    np.testing.assert_allclose(got.numpy(), mm.numpy(), atol=1e-4)


@pytest.mark.parametrize("case", CASES)
def test_matmul_form_matches_jax(case):
    feats, boxes, scale, p, s = _case(case)
    want = np.asarray(jax_roi_align(jnp.asarray(feats), jnp.asarray(boxes), spatial_scale=scale,
                                    output_size=p, sampling_ratio=s))
    got = roi_align(torch.from_numpy(feats), torch.from_numpy(boxes), scale, p, s)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_multilevel_matches_jax():
    rng = np.random.default_rng(2)
    levels = {3: rng.normal(0, 1, (40, 60, 4)).astype(np.float32),
              4: rng.normal(0, 1, (20, 30, 4)).astype(np.float32)}
    strides = {3: 8, 4: 16}
    boxes = np.array([[10, 10, 110, 110], [0, 0, 400, 300], [30, 20, 60, 70]], np.float32)
    want = np.asarray(jax_multilevel({k: jnp.asarray(v) for k, v in levels.items()},
                                     jnp.asarray(boxes), strides, output_size=7))
    got = roi_align_multilevel({k: torch.from_numpy(v) for k, v in levels.items()},
                               torch.from_numpy(boxes), strides, output_size=7)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_kernel_reference_batched_bf16_and_contract():
    rng = np.random.default_rng(7)
    feats = torch.from_numpy(rng.normal(0, 1, (3, 12, 20, 6)).astype(np.float32))
    xy = rng.uniform(-10, 120, (3, 5, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + rng.uniform(2, 60, (3, 5, 2))], -1)
                             .astype(np.float32))
    batched = roi_align_kernel_reference(feats, boxes, 0.125, 7, 2)
    for i in range(3):       # a batch is its images one by one, exactly
        assert torch.equal(batched[i], roi_align_kernel(feats[i], boxes[i], 0.125, 7, 2))
    np.testing.assert_allclose(batched.numpy(),
                               roi_align_batched(feats, boxes, 0.125, 7, 2).numpy(), atol=1e-4)
    # bf16 features: f32 accumulation of the bf16 values, one rounding at the end
    half = roi_align_kernel_reference(feats.bfloat16(), boxes, 0.125, 7, 2)
    want = roi_align_kernel_reference(feats.bfloat16().float(), boxes, 0.125, 7, 2)
    assert half.dtype == torch.bfloat16 and torch.equal(half, want.bfloat16())
    with pytest.raises(ValueError, match="2 x 2"):
        roi_align_kernel(feats[0, :1], boxes[0])
    with pytest.raises(ValueError, match="CUDA"):
        roi_align_cuda(feats, boxes)
