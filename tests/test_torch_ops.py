"""The port's ops against the JAX package, on the same numpy inputs.

- NMS: the plain keep-mask (what a CPU tensor runs, and what the CUDA
  kernel is held to on the card) against the Pallas kernel in interpret
  mode, bit for bit; ``nms_batched`` against JAX's, exactly.
- Auction: the plain version of the kernel against the Pallas kernel in
  interpret mode on ``_build_benefit`` inputs at n=64 (equal row->col);
  the CPU ``auction_assign`` against JAX's while-loop path (equal ids) and
  the scipy optimality bound; ``greedy_assign`` exactly. Two numpy models
  rehearse the warp design of ``csrc/auction.cu``: its column phase (the
  bidders walked in ascending row order, a column keeping only a strictly
  greater bid) gives the plain version's row->col on the same problems and
  on one at n=128, and its row phase (a max over the lanes' order-preserving
  keys, a ballot for the lowest column holding it, a second max for the
  other columns, when a round has few bidders; one lane per bidder scanning
  in two chains, when it has many) gives the same (best, lowest index of
  best, second best) as a plain argmax, ties and signed zeros included, and
  its many-bidder column phase (a per-column max of the key (bid, ~row))
  gives the ascending walk's winners.
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
    got, rounds, bids, bidders = auction_kernel_reference(
        b[None], e.reshape(1), torch.tensor([True]),
        eps_scale=0.2, eps_min=1e-2, max_iters=4096)
    np.testing.assert_array_equal(got[0].numpy(), want)
    # every round has at least one bidder, and at most all n rows bid
    assert 0 < int(rounds[0]) <= int(bids[0]) <= 64 * int(rounds[0])
    # the histogram of bidders per round adds up to the rounds and the bids
    assert int(bidders[0, 0]) == 0 and int(bidders[0].sum()) == int(rounds[0])
    assert int((bidders[0] * torch.arange(65)).sum()) == int(bids[0])


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
    got, rounds, bids, _ = auction_kernel_reference(
        torch.stack(benefits), torch.stack(eps0), feasible,
        eps_scale=0.2, eps_min=1e-2, max_iters=4096)
    for i in (0, 2):
        one, *_ = auction_kernel_reference(benefits[i][None], eps0[i].reshape(1),
                                           torch.tensor([True]), eps_scale=0.2,
                                           eps_min=1e-2, max_iters=4096)
        np.testing.assert_array_equal(got[i].numpy(), one[0].numpy())
    assert (got[1] == -1).all() and int(rounds[1]) == 0 and int(bids[1]) == 0


def _warp_auction_model(b, eps0, eps_scale, eps_min, max_iters):
    """numpy model of one problem in ``csrc/auction.cu``: the Pallas schedule
    with the kernel's column phase. Each round the unassigned rows bid
    against the prices at the start of the round; then the bidders are
    walked in ascending row order and a column keeps a bid only if it is
    strictly greater, so ties go to the lowest row. float32 throughout."""
    n = b.shape[0]
    neg = np.float32(-1e30)
    price = np.zeros(n, np.float32)
    rtc = np.full(n, -1, np.int32)
    eps, eps_min_f = np.float32(eps0), np.float32(eps_min)
    eps_stop = np.float32(eps_min * 1.000001)
    while eps > 0:
        e = max(eps, eps_min_f)
        rtc[:] = -1
        owner = np.full(n, -1, np.int32)
        for _ in range(max_iters):
            bidders = np.nonzero(rtc < 0)[0]                # ascending rows
            if bidders.size == 0:
                break
            v = b[bidders] - price[None, :]
            j1 = v.argmax(axis=1)                           # lowest index among equal maxima
            b1 = b[bidders, j1]
            v[np.arange(bidders.size), j1] = neg
            v2 = np.maximum(v.max(axis=1), neg)
            bid = (b1 - v2) + e
            best = np.full(n, neg, np.float32)
            win = np.full(n, n, np.int32)
            for t, i in enumerate(bidders):
                if bid[t] > best[j1[t]]:
                    best[j1[t]], win[j1[t]] = bid[t], i
            for j in np.nonzero(best > neg * np.float32(0.5))[0]:
                if owner[j] >= 0:
                    rtc[owner[j]] = -1
                price[j], owner[j], rtc[win[j]] = best[j], win[j], j
        eps = np.float32(0) if e <= eps_stop else eps * np.float32(eps_scale)
    return rtc


def _order_key(x):
    """The kernel's order-preserving uint32 key of float32 values (-0.0 as +0.0)."""
    u = np.asarray(x, np.float32).view(np.uint32).copy()
    u[u == np.uint32(0x80000000)] = 0
    return np.where(u >> 31 == 1, ~u, u | np.uint32(0x80000000)).astype(np.uint32)


def _key_value(key):
    key = np.uint32(key)
    bits = key & np.uint32(0x7FFFFFFF) if key >> 31 else ~key
    return np.uint32(bits).view(np.float32)


def _warp_row_phase(v):
    """(v1, j1, v2) of one bidder's row as the kernel's warp finds them: lane
    l holds columns l, l + 32, ...; v1 is the max over the lanes' keys of
    their maxima; j1 the lowest column equal to v1 (a ballot per register,
    the lowest register first); v2 the max of the keys of each lane's best
    over its other columns, floored at -1e30."""
    n = v.shape[0]
    lanes = v.reshape(n // 32, 32)                      # [register q, lane]
    v1 = _key_value(_order_key(lanes.max(axis=0)).max())
    j1 = n
    for q in reversed(range(n // 32)):
        hit = np.nonzero(lanes[q] == v1)[0]
        if hit.size:
            j1 = q * 32 + int(hit[0])
    other = np.where(np.arange(n).reshape(n // 32, 32) == j1, np.float32(-1e30), lanes)
    m2 = np.maximum(other.max(axis=0), np.float32(-1e30))
    return v1, j1, _key_value(_order_key(m2).max())


def _auction_problems():
    for shape, n, seed in (((64, 64), 64, 128), ((40, 64), 64, 104), ((64, 9), 64, 73),
                           ((30, 50), 64, 5), ((121, 108), 128, 11)):
        cost, rm, cm, fb = _assign_problem(np.random.default_rng(seed), *shape)
        b, e = _build_benefit(T(cost), T(rm[:, None] & cm[None, :] & ~fb), n, 1e-2)
        yield f"{shape[0]}x{shape[1]}_n{n}", b, e


@pytest.mark.parametrize("case", list(_auction_problems()), ids=lambda c: c[0])
def test_auction_warp_model_matches_reference(case):
    _, b, e = case
    want, *_ = auction_kernel_reference(b[None], e.reshape(1), torch.tensor([True]),
                                        eps_scale=0.2, eps_min=1e-2, max_iters=4096)
    got = _warp_auction_model(b.numpy(), float(e), 0.2, 1e-2, 4096)
    np.testing.assert_array_equal(got, want[0].numpy())


def _lane_scan(v, b):
    """(v1, j1, v2, b1) of one bidder's row as one lane of the kernel finds
    them when a round has many bidders: two branch-free chains over the even
    and the odd columns in ascending order (v1 = max, v2 = max(v2, min(v1,
    v)), j1 moves on a strictly greater value), then merged, the lower column
    winning a tie; b1 is read back at j1."""
    def scan(cols):
        v1, j1, v2 = np.float32(-np.inf), 0, np.float32(-1e30)
        for j in cols:
            j1 = j if v[j] > v1 else j1
            v2 = max(v2, min(v1, v[j]))
            v1 = max(v1, v[j])
        return v1, j1, v2

    (v1, j1, v2), (o1, oj, o2) = scan(range(0, v.shape[0], 2)), scan(range(1, v.shape[0], 2))
    j1 = oj if (o1 > v1 or (o1 == v1 and oj < j1)) else j1
    return max(v1, o1), j1, max(min(v1, o1), max(v2, o2)), b[j1]


def _column_winners_by_key(j1, bid, rows, n):
    """The kernel's column phase for many bidders: per column the max of the
    64-bit (order-preserving key of the bid, ~row)."""
    slot = np.zeros(n, np.uint64)
    keys = (_order_key(bid).astype(np.uint64) << np.uint64(32)) | (
        ~np.asarray(rows, np.uint32)).astype(np.uint64)
    np.maximum.at(slot, j1, keys)
    best = np.where(slot > 0, [_key_value(k >> np.uint64(32)) for k in slot], np.float32(-1e30))
    win = np.where(slot > 0, (~(slot & np.uint64(0xFFFFFFFF)).astype(np.uint32)).astype(np.int64), n)
    return best.astype(np.float32), win


@pytest.mark.parametrize("n", [32, 64, 96, 128])
def test_auction_many_bidders_match_walk(n):
    """Many-bidder rounds: each lane's two-chain scan equals a plain argmax,
    and the (bid key, ~row) maximum per column equals the ascending walk."""
    rng = np.random.default_rng(n + 1)
    for trial in range(6):
        b = (np.round(rng.normal(0, 1, n) * (2 if trial % 2 else 8)) / 4).astype(np.float32)
        price = (np.round(rng.uniform(0, 1, n) * 2) / 4).astype(np.float32)
        v = b - price
        j1 = int(v.argmax())
        got = _lane_scan(v, b)
        want = (v[j1], j1, np.float32(np.delete(v, j1).max()), b[j1])
        assert tuple(float(x) for x in got) == tuple(float(x) for x in want), (n, trial)
        # bids on few columns with ties, zeros of both signs among them
        rows = np.sort(rng.choice(n, size=min(n, 40), replace=False))
        cols = rng.integers(0, 6, rows.size)
        bid = (np.round(rng.normal(0, 1, rows.size) * 2) / 2).astype(np.float32)
        bid[rng.integers(0, rows.size, 4)] = np.float32(-0.0)
        best, win = _column_winners_by_key(cols, bid, rows, n)
        walk_best = np.full(n, np.float32(-1e30))
        walk_win = np.full(n, n)
        for t, i in enumerate(rows):
            if bid[t] > walk_best[cols[t]]:
                walk_best[cols[t]], walk_win[cols[t]] = bid[t], i
        np.testing.assert_array_equal(win, walk_win)
        np.testing.assert_array_equal(best, walk_best)


@pytest.mark.parametrize("n", [32, 64, 96, 128])
def test_auction_warp_row_phase_matches_argmax(n):
    rng = np.random.default_rng(n)
    for trial in range(8):
        # coarse values so that maxima tie, within a lane and across lanes;
        # the last trials make zeros of both signs the maximum
        b = (np.round(rng.normal(0, 1, n) * (2 if trial % 2 else 8)) / 4).astype(np.float32)
        price = (np.round(rng.uniform(0, 1, n) * 2) / 4).astype(np.float32)
        if trial >= 6:
            b = np.minimum(b, 0).astype(np.float32)
            b[rng.integers(0, n, 5)] = np.float32(-0.0)
            price[:] = 0
        v = b - price
        j1 = int(v.argmax())
        v2 = np.float32(np.delete(v, j1).max())
        got = _warp_row_phase(v)
        assert (float(got[0]), got[1], float(got[2])) == (float(v[j1]), j1, float(v2)), (n, trial)


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


def _wide_row_phase(v):
    """(v1, j1, v2) of one bidder's row as ``auction_wide`` (n > 128) finds
    them: lane l scans columns l, l + 32, ... in ascending order (the
    branch-free chain), then five butterfly steps (xor 16, 8, 4, 2, 1)
    merge the lanes, the lower column winning a tie; every lane ends equal."""
    n = v.shape[0]
    lanes = []
    for lane in range(32):
        v1, j1, v2 = np.float32(-np.inf), 0, np.float32(-1e30)
        for j in range(lane, n, 32):
            j1 = j if v[j] > v1 else j1
            v2 = max(v2, min(v1, v[j]))
            v1 = max(v1, v[j])
        lanes.append((v1, j1, v2))
    for off in (16, 8, 4, 2, 1):
        merged = []
        for lane in range(32):
            (a1, aj, a2), (o1, oj, o2) = lanes[lane], lanes[lane ^ off]
            j1 = oj if (o1 > a1 or (o1 == a1 and oj < aj)) else aj
            merged.append((max(a1, o1), j1, max(min(a1, o1), max(a2, o2))))
        lanes = merged
    assert len(set((float(a), j, float(b)) for a, j, b in lanes)) == 1
    return lanes[0]


@pytest.mark.parametrize("n", [256, 384])
def test_auction_wide_row_phase_matches_argmax(n):
    rng = np.random.default_rng(n)
    for trial in range(6):
        # coarse values so that maxima tie within a lane and across lanes
        b = (np.round(rng.normal(0, 1, n) * (2 if trial % 2 else 8)) / 4).astype(np.float32)
        price = (np.round(rng.uniform(0, 1, n) * 2) / 4).astype(np.float32)
        v = b - price
        j1 = int(v.argmax())
        got = _wide_row_phase(v)
        want = (v[j1], j1, np.float32(np.delete(v, j1).max()))
        assert tuple(float(x) for x in got) == tuple(float(x) for x in want), (n, trial)


def test_auction_reference_at_n256_within_scipy_bound():
    """A 230 x 200 tracker-like problem padded to n = 256 (past the one-warp
    kernel's 128): the plain version of the kernel, which the wide kernel is
    held to on the card, meets scipy's optimum within n * eps_min."""
    rng = np.random.default_rng(256)
    cost, row_mask, col_mask, forbid = _assign_problem(rng, 230, 200, p_forbid=0.6)
    valid = row_mask[:, None] & col_mask[None, :] & ~forbid
    b, e = _build_benefit(T(cost), T(valid), 256, 1e-2)
    rtc, rounds, _, _ = auction_kernel_reference(b[None], e.reshape(1), torch.tensor([True]),
                                                 eps_scale=0.2, eps_min=1e-2, max_iters=4096)
    rtc = rtc[0, :230].numpy()
    pairs = [(i, j) for i, j in enumerate(rtc) if 0 <= j < 200 and valid[i, j]]
    sub = np.where(valid, cost, 1e6)
    ri, ci = linear_sum_assignment(sub)
    keep = sub[ri, ci] < 5e5
    assert len(pairs) == int(keep.sum()) > 150
    assert sum(cost[i, j] for i, j in pairs) <= sub[ri, ci][keep].sum() + 256 * 1e-2 + 1e-4
    assert int(rounds[0]) > 0
