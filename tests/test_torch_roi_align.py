"""The port's RoIAlign against the JAX package.

- ``roi_align_kernel_reference`` (the plain version of ``csrc/roi_align.cu``)
  vs the Pallas ``_roi_align_kernel`` in interpret mode, atol 1e-5: the same
  f32 arithmetic, where XLA may order the window sum's zero terms otherwise;
  one map has H >= 32, so that the Pallas kernel's 32-row window branch runs.
- the single-image matmul form ``roi_align`` / ``roi_align_multilevel`` vs
  JAX, atol 1e-5 (matrix products sum in another order);
- the kernel's plain version vs the matmul form, atol 1e-4 (the separable
  products sum the same terms in another order);
- a numpy model of the work split of ``csrc/roi_align.cu`` (the widest vector
  of channels that divides C and that the address allows, the (channel group,
  output column) thread layout with its strided loops, the RoI's rows split
  over CTAs or kept together) writes every output exactly once and equals the
  plain version bit for bit, at C = 100 and C = 8 among others;
- boxes of zero width, with x2 < x1 and wholly outside the map: the plain
  version vs the Pallas kernel in interpret mode, atol 1e-5 as above.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waymo_2d_tracking_tpu.ops.roi_align import pallas_roi_align
from waymo_2d_tracking_tpu.ops.roi_align import roi_align as jax_roi_align
from waymo_2d_tracking_tpu.ops.roi_align import roi_align_multilevel as jax_multilevel

from waymo_2d_tracking_tpu_torch.ops.roi_align import (
    _bin_size,
    _sample_params,
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


def _work_split_model(feats, boxes, scale, p, s, elem_bytes, address, split_ctas=2048,
                      max_threads=256):
    """``csrc/roi_align.cu`` as loops over its grid and its threads, float32
    numpy: returns (out, times each output was written, V, rows per CTA)."""
    n, h, w, c = feats.shape
    r = boxes.shape[1]
    v = 16 // elem_bytes                       # the widest vector C and the address allow
    while v > 1 and (c % v or address % (v * elem_bytes)):
        v //= 2
    bx = min(c // v, max_threads)
    by = min(max_threads // bx, p)
    rows = min(max((r * n * p) // split_ctas, 1), p)
    b = torch.from_numpy(boxes.reshape(-1, 4))
    fx1, fy1 = b[:, 0] * scale - 0.5, b[:, 1] * scale - 0.5
    fx2, fy2 = b[:, 2] * scale - 0.5, b[:, 3] * scale - 0.5
    y0, wy_lo, wy_hi = (t.numpy() for t in _sample_params(fy1, _bin_size(fy1, fy2, p), p, s, h))
    x0, wx_lo, wx_hi = (t.numpy() for t in _sample_params(fx1, _bin_size(fx1, fx2, p), p, s, w))
    out = np.full((n, r, p, p, c), np.nan, np.float32)
    written = np.zeros(out.shape, np.int32)
    for img in range(n):
        for roi in range(r):
            k = img * r + roi
            for z in range(-(-p // rows)):                       # blockIdx.z
                for pi in range(z * rows, min(z * rows + rows, p)):
                    for ty in range(by):
                        for qi in range(ty, p, by):
                            for tx in range(bx):
                                for ch in range(tx * v, c, bx * v):
                                    sl = slice(ch, ch + v)
                                    acc = np.zeros(v, np.float32)
                                    for b_ in range(s):
                                        xx = x0[k, qi * s + b_]
                                        g_lo = np.zeros(v, np.float32)
                                        g_hi = np.zeros(v, np.float32)
                                        for a in range(s):
                                            yy = y0[k, pi * s + a]
                                            lo, hi = wy_lo[k, pi * s + a], wy_hi[k, pi * s + a]
                                            g_lo = g_lo + (lo * feats[img, yy, xx, sl]
                                                           + hi * feats[img, yy + 1, xx, sl])
                                            g_hi = g_hi + (lo * feats[img, yy, xx + 1, sl]
                                                           + hi * feats[img, yy + 1, xx + 1, sl])
                                        acc = (acc + wx_lo[k, qi * s + b_] * g_lo) \
                                            + wx_hi[k, qi * s + b_] * g_hi
                                    out[img, roi, pi, qi, sl] = acc
                                    written[img, roi, pi, qi, sl] += 1
    return out, written, v, rows


# zero width, x2 < x1, wholly outside above left and below right, one ordinary
DEGENERATE = np.array([[40.0, 30.0, 40.0, 90.0], [120.0, 30.0, 60.0, 90.0],
                       [-300.0, -200.0, -100.0, -50.0], [400.0, 300.0, 500.0, 420.0],
                       [10.0, 12.0, 150.0, 100.0]], np.float32)


@pytest.mark.parametrize("c,elem_bytes,address,split_ctas,want_v,want_rows", [
    (100, 4, 0, 2048, 4, 1),      # f32: 16-byte vectors divide 100 channels
    (100, 2, 0, 2048, 4, 1),      # bf16: 8 channels do not, 4 do (8-byte vectors)
    (8, 2, 0, 2048, 8, 1),        # one 16-byte vector a pixel
    (8, 4, 0, 2048, 4, 1),
    (8, 2, 2, 2048, 1, 1),        # one element past a 16-byte boundary: scalar
    (8, 4, 8, 2048, 2, 1),        # 8-byte aligned only
    (6, 4, 0, 2048, 2, 1),
    (100, 4, 0, 4, 4, 4),         # many RoIs for the CTAs wanted: whole RoI a CTA
    (8, 2, 0, 10, 8, 2),          # rows in groups of 2, the last group short
])
def test_work_split_model_matches_reference(c, elem_bytes, address, split_ctas, want_v, want_rows):
    rng = np.random.default_rng(c + elem_bytes)
    feats = rng.normal(0, 1, (2, 9, 11, c)).astype(np.float32)
    xy = rng.uniform(-10, 70, (2, 2, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, 50, (2, 2, 2))], -1).astype(np.float32)
    boxes = np.concatenate([boxes, np.broadcast_to(DEGENERATE[:1], (2, 1, 4))], 1)
    p, s = 4, 2
    got, written, v, rows = _work_split_model(feats, boxes, 0.125, p, s, elem_bytes, address,
                                              split_ctas, max_threads=64)
    assert (v, rows) == (want_v, want_rows)
    assert (written == 1).all()
    want = roi_align_kernel_reference(torch.from_numpy(feats), torch.from_numpy(boxes),
                                      0.125, p, s).numpy()
    np.testing.assert_array_equal(got, want)


def test_degenerate_and_outside_boxes_match_pallas():
    rng = np.random.default_rng(12)
    feats = rng.normal(0, 1, (20, 30, 8)).astype(np.float32)
    want = np.asarray(pallas_roi_align(jnp.asarray(feats), jnp.asarray(DEGENERATE),
                                       spatial_scale=0.125, output_size=7, sampling_ratio=2,
                                       interpret=True))
    got = roi_align_kernel(torch.from_numpy(feats), torch.from_numpy(DEGENERATE), 0.125, 7, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert (got[2:4] == 0).all() and got[4].abs().max() > 0     # outside boxes pool nothing
    # a zero-width box samples one column: every output column is the same
    np.testing.assert_allclose(got[0, :, :1].numpy().repeat(7, 1), got[0].numpy(), atol=1e-6)
