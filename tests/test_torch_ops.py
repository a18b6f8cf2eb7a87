"""The port's ops against the JAX package, on the same numpy inputs.

- NMS: the plain keep-mask (what a CPU tensor runs, and what the CUDA
  kernel is held to on the card) against the Pallas kernel in interpret
  mode, bit for bit; ``nms_batched`` against JAX's, exactly.
- Auction: the plain version of the kernel against the Pallas kernel in
  interpret mode on ``_build_benefit`` inputs at n=64 (equal row->col);
  the CPU ``auction_assign`` against JAX's while-loop path (equal ids) and
  the scipy optimality bound; ``greedy_assign`` exactly.
- IoU and RoIAlign within f32 rounding (atol 1e-5).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from waymo_2d_tracking_tpu.ops import assign as jassign
from waymo_2d_tracking_tpu.ops.iou import pairwise_iou as jax_iou
from waymo_2d_tracking_tpu.ops.nms import nms_batched as jax_nms_batched
from waymo_2d_tracking_tpu.ops.nms import pallas_nms_mask_batched
from waymo_2d_tracking_tpu.ops.roi_align import (
    roi_align_batched as jax_roi_align,
    roi_align_multilevel_batched as jax_roi_align_ml,
)

from waymo_2d_tracking_tpu_torch.ops.assign import (
    _build_benefit,
    auction_assign,
    auction_kernel_reference,
    greedy_assign,
)
from waymo_2d_tracking_tpu_torch.ops.iou import pairwise_iou
from waymo_2d_tracking_tpu_torch.ops.nms import nms_batched, nms_mask_batched
from waymo_2d_tracking_tpu_torch.ops.roi_align import (
    roi_align_batched,
    roi_align_multilevel_batched,
)

# xdist runs several workers on the machine's cores; a torch thread pool the
# width of the machine in each would oversubscribe them, and the port's CPU
# ops are small, so one thread each is fastest.
torch.set_num_threads(1)

T = torch.from_numpy


def sorted_boxes(rng, b, n, spread=400.0, classes=0):
    xy = rng.uniform(0, spread, size=(b, n, 2))
    wh = rng.uniform(10, 80, size=(b, n, 2))
    boxes = np.concatenate([xy, xy + wh], axis=-1)
    if classes:
        boxes += (rng.integers(0, classes, size=(b, n, 1)) * 1e5)
    return boxes.astype(np.float32)


def test_pairwise_iou():
    rng = np.random.default_rng(0)
    a, b = sorted_boxes(rng, 3, 7), sorted_boxes(rng, 3, 5)
    np.testing.assert_allclose(pairwise_iou(T(a), T(b)).numpy(),
                               np.asarray(jax_iou(jnp.asarray(a), jnp.asarray(b))),
                               atol=1e-6)


def _nms_cases():
    rng = np.random.default_rng(1)
    chain = np.array([[[0, 0, 10, 10], [6, 0, 16, 10], [12, 0, 22, 10]]], np.float32)
    yield "multiblock", sorted_boxes(rng, 3, 384), np.ones((3, 384), bool), 0.5
    yield "chain_revival", chain, np.ones((1, 3), bool), 0.2
    yield "invalid", sorted_boxes(rng, 2, 200), rng.uniform(size=(2, 200)) > 0.4, 0.5
    yield ("class_offset", sorted_boxes(rng, 2, 300, spread=150.0, classes=3),
           rng.uniform(size=(2, 300)) > 0.1, 0.6)


@pytest.mark.parametrize("case", list(_nms_cases()), ids=lambda c: c[0])
def test_nms_mask_bit_exact_vs_pallas_interpret(case):
    _, boxes, valid, thr = case
    want = np.asarray(pallas_nms_mask_batched(jnp.asarray(boxes), jnp.asarray(valid),
                                              thr, interpret=True))
    got = nms_mask_batched(T(boxes), T(valid), thr).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()


def test_nms_batched_matches_jax():
    rng = np.random.default_rng(3)
    boxes = sorted_boxes(rng, 4, 160, spread=200.0, classes=3)
    scores = rng.uniform(0.01, 1.0, size=(4, 160)).astype(np.float32)
    scores[:, ::7] = scores[:, :1]                     # equal scores: tie order
    want = jax_nms_batched(jnp.asarray(boxes), jnp.asarray(scores), 0.6,
                           max_outputs=48, score_threshold=0.05, interpret=True)
    got = nms_batched(T(boxes), T(scores), 0.6, max_outputs=48, score_threshold=0.05)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _assign_problem(rng, r, c, p_forbid=0.1, p_row=0.85):
    cost = rng.uniform(0, 2, size=(r, c)).astype(np.float32)
    row_mask = rng.uniform(size=r) < p_row
    col_mask = rng.uniform(size=c) < 0.9
    forbid = rng.uniform(size=(r, c)) < p_forbid
    return cost, row_mask, col_mask, forbid


@pytest.mark.parametrize("shape", [(64, 64), (40, 64), (64, 9)])
def test_auction_kernel_reference_matches_pallas_interpret(shape):
    rng = np.random.default_rng(sum(shape))
    cost, row_mask, col_mask, forbid = _assign_problem(rng, *shape)
    valid = row_mask[:, None] & col_mask[None, :] & ~forbid
    jb, je = jassign._build_benefit(jnp.asarray(cost), jnp.asarray(valid), 64, 1e-2)
    want = np.asarray(jassign._pallas_auction(jb, je, eps_scale=0.2, eps_min=1e-2,
                                              max_iters=4096, interpret=True))
    b, e = _build_benefit(T(cost), T(valid), 64, 1e-2)
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    assert float(e) == float(je)
    got, rounds, bids = auction_kernel_reference(
        b[None], e.reshape(1), torch.tensor([True]),
        eps_scale=0.2, eps_min=1e-2, max_iters=4096)
    np.testing.assert_array_equal(got[0].numpy(), want)
    # every round has at least one bidder, and at most all n rows bid
    assert 0 < int(rounds[0]) <= int(bids[0]) <= 64 * int(rounds[0])


def test_auction_kernel_reference_batch_and_infeasible():
    """Lockstep batching gives each problem its own result; an infeasible
    problem returns all -1 without bidding."""
    rng = np.random.default_rng(5)
    benefits, eps0, singles = [], [], []
    for r, c in [(64, 64), (30, 50), (64, 3)]:
        cost, rm, cm, fb = _assign_problem(rng, r, c)
        b, e = _build_benefit(T(cost), T(rm[:, None] & cm[None, :] & ~fb), 64, 1e-2)
        benefits.append(b)
        eps0.append(e)
    feasible = torch.tensor([True, False, True])
    got, rounds, bids = auction_kernel_reference(
        torch.stack(benefits), torch.stack(eps0), feasible,
        eps_scale=0.2, eps_min=1e-2, max_iters=4096)
    for i in (0, 2):
        one, _, _ = auction_kernel_reference(benefits[i][None], eps0[i].reshape(1),
                                          torch.tensor([True]), eps_scale=0.2,
                                          eps_min=1e-2, max_iters=4096)
        np.testing.assert_array_equal(got[i].numpy(), one[0].numpy())
    assert (got[1] == -1).all() and int(rounds[1]) == 0 and int(bids[1]) == 0


def _total(cost, rtc):
    return sum(cost[i, j] for i, j in enumerate(rtc) if j >= 0)


@pytest.mark.parametrize("shape,eps_min", [((8, 8), 1e-3), ((20, 12), 1e-2),
                                           ((12, 30), 1e-2), ((64, 64), 1e-2)])
def test_auction_assign_cpu_matches_jax_while_loop(shape, eps_min):
    rng = np.random.default_rng(shape[0] * 100 + shape[1])
    cost, row_mask, col_mask, forbid = _assign_problem(rng, *shape, p_forbid=0.2)
    jr, jc = jassign.auction_assign(
        jnp.asarray(cost), jnp.asarray(row_mask), jnp.asarray(col_mask),
        jnp.asarray(forbid), eps_scale=0.2, eps_min=eps_min, max_iters=4096,
        use_pallas=False)
    rtc, ctr = auction_assign(T(cost), T(row_mask), T(col_mask), T(forbid),
                              eps_scale=0.2, eps_min=eps_min, max_iters=4096)
    np.testing.assert_array_equal(rtc.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(ctr.numpy(), np.asarray(jc))

    # optimality vs scipy on the feasible submatrix (tests/unit/test_assign.py)
    big = 1e6
    sub = np.where(forbid | ~col_mask[None, :], big, cost)[row_mask]
    ri, ci = linear_sum_assignment(sub)
    keep = sub[ri, ci] < big / 2
    rtc = rtc.numpy()
    assert sum(1 for j in rtc if j >= 0) == int(keep.sum())
    assert _total(cost, rtc) <= sub[ri, ci][keep].sum() + max(shape) * eps_min + 1e-5


def test_greedy_assign_matches_jax():
    rng = np.random.default_rng(7)
    for r, c, p_forbid in ((8, 8, 0.0), (12, 5, 0.5), (5, 12, 0.5), (16, 16, 1.0)):
        cost, row_mask, col_mask, forbid = _assign_problem(rng, r, c, p_forbid, 0.8)
        want = jassign.greedy_assign(jnp.asarray(cost), jnp.asarray(row_mask),
                                     jnp.asarray(col_mask), jnp.asarray(forbid))
        got = greedy_assign(T(cost), T(row_mask), T(col_mask), T(forbid))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_roi_align_matches_jax():
    rng = np.random.default_rng(9)
    feats = {3: rng.normal(size=(2, 20, 30, 8)).astype(np.float32),
             4: rng.normal(size=(2, 10, 15, 8)).astype(np.float32),
             5: rng.normal(size=(2, 5, 8, 8)).astype(np.float32)}
    xy = rng.uniform(-10, 200, size=(2, 19, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, 120, size=(2, 19, 2))],
                           axis=-1).astype(np.float32)
    want = jax_roi_align(jnp.asarray(feats[3]), jnp.asarray(boxes), spatial_scale=1 / 8)
    got = roi_align_batched(T(feats[3]), T(boxes), spatial_scale=1 / 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    strides = {lvl: 2 ** lvl for lvl in feats}
    want = jax_roi_align_ml({k: jnp.asarray(v) for k, v in feats.items()},
                            jnp.asarray(boxes), strides)
    got = roi_align_multilevel_batched({k: T(v) for k, v in feats.items()}, T(boxes), strides)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
