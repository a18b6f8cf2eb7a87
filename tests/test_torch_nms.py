"""The schedule of ``csrc/nms.cu`` rehearsed in numpy, and the plain NMS
keep-mask at the sizes the kernel newly takes.

- ``_kernel_model`` is the kernel's schedule for one image in float32 numpy:
  blocks of 32 boxes owned by warps, the in-block word of every live box
  computed up front, then block after block the test of every live later box
  against the compact list of the boxes just kept (four a round in the
  kernel), the owner's fixpoint of ballots, and the multiplication that keeps
  the division for hits and near misses only. It is held bit-equal to
  ``nms_mask_reference`` on the cases of ``test_torch_ops._nms_cases`` and on
  the adversarial cases ``chip_smoke.py`` runs on the card (pairs a few
  float32 steps either side of the threshold, 1024 copies of one box, a chain
  of neighbours, nothing valid, a negative and a zero threshold, N = 2048).
- The filter's claim on its own: a pair below ``thr * (1 - 2^-20) * union``
  never has a rounded quotient above ``thr``.
- ``nms_mask_reference`` at N = 2048 and at an N that is no multiple of 128
  against the Pallas kernel in interpret mode, bit for bit; ``nms_batched``
  with 2048 candidates against JAX's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_isolation import _chip_smoke
from test_torch_ops import _nms_cases, sorted_boxes
from waymo_2d_tracking_tpu.ops.nms import nms_batched as jax_nms_batched
from waymo_2d_tracking_tpu.ops.nms import pallas_nms_mask_batched

from waymo_2d_tracking_tpu_torch.ops.nms import (
    SHARED_MAX_N,
    nms_batched,
    nms_mask_batched,
    nms_mask_cuda,
    nms_mask_reference,
)

torch.set_num_threads(1)

F = np.float32
BELOW = F(1.0) - F(2.0 ** -20)


def _area(b):
    return np.maximum(b[..., 2] - b[..., 0], F(0)) * np.maximum(b[..., 3] - b[..., 1], F(0))


def _inter_union(others, me):
    """float32 inter and max(union, 1e-7) of each box of ``others`` (K, 4)
    with each box of ``me`` (M, 4): (M, K), every operation rounded on its own."""
    iw = np.maximum(np.minimum(others[None, :, 2], me[:, None, 2])
                    - np.maximum(others[None, :, 0], me[:, None, 0]), F(0))
    ih = np.maximum(np.minimum(others[None, :, 3], me[:, None, 3])
                    - np.maximum(others[None, :, 1], me[:, None, 1]), F(0))
    inter = iw * ih
    uni = np.maximum((_area(others)[None, :] + _area(me)[:, None]) - inter, F(1e-7))
    return inter, uni


def _hits(others, me, thr, stats):
    """(M, K) bool: ``others[k]`` removes ``me[m]``, as the kernel decides it."""
    thr = F(thr)
    if F(0) > thr:                                   # every pair is a hit
        return np.ones((me.shape[0], others.shape[0]), bool)
    below = thr * BELOW if thr >= F(2.0 ** -20) else F(0)
    inter, uni = _inter_union(others, me)
    near = inter >= below * uni                      # only these divide
    with np.errstate(divide="ignore", invalid="ignore"):
        over = np.where(near, inter / uni, F(0)) > thr
    stats["pairs"] += near.size
    stats["divided"] += int(near.sum())
    stats["near_miss"] += int((near & ~over).sum())
    return near & over


def _kernel_model(boxes, valid, thr, nwarps=32):
    """One image through the schedule of ``csrc/nms.cu``; returns (keep, stats)."""
    stats = {"pairs": 0, "divided": 0, "near_miss": 0, "rounds": 0}
    n = boxes.shape[0]
    nblk = (n + 31) // 32
    pad = np.zeros((nblk * 32, 4), F)
    pad[:n] = boxes
    dead = np.ones(nblk * 32, bool)
    dead[:n] = ~valid
    owner = [blk % nwarps for blk in range(nblk)]     # warp w owns w, w + nwarps, ...
    # up front: which earlier live boxes of its own block would remove box j
    own = np.zeros((nblk * 32, 32), bool)
    for blk in range(nblk):
        sl = slice(blk * 32, blk * 32 + 32)
        live = ~dead[sl]
        h = _hits(pad[sl], pad[sl], thr, stats)       # [me, other]
        own[sl] = h & np.tril(np.ones((32, 32), bool), -1) & live[None, :] & live[:, None]
    keep = np.zeros(nblk * 32, bool)
    kept_list = np.zeros((0, 4), F)
    for blk in range(nblk):
        if len(kept_list):
            # the owner of blk tests that block first, then every warp its later
            # blocks: the order does not matter to the result
            order = sorted(range(blk, nblk), key=lambda b: (owner[b] != owner[blk], b))
            for later in order:
                sl = slice(later * 32, later * 32 + 32)
                live = np.nonzero(~dead[sl])[0]
                if live.size:
                    hit = _hits(kept_list, pad[sl][live], thr, stats).any(axis=1)
                    dead[later * 32 + live[hit]] = True
        sl = slice(blk * 32, blk * 32 + 32)
        live = ~dead[sl]
        kept = live.copy()
        for _ in range(32):                            # the fixpoint of ballots
            stats["rounds"] += 1
            nxt = live & ~(own[sl] & kept[None, :]).any(axis=1)
            if (nxt == kept).all():
                break
            kept = nxt
        keep[sl] = kept
        kept_list = pad[sl][kept]                      # the compact list, in box order
    return keep[:n], stats


def _adversarial_cases():
    smoke = _chip_smoke()
    for name, boxes, valid, thr in smoke.nms_edge_cases(torch):
        if boxes.shape[1] > 2048:
            continue                                   # N = 4096 runs on the card
        keep = 2 if boxes.shape[1] > 1000 else 8       # a few images are enough here
        if name == "near the threshold":
            keep = boxes.shape[0]
        yield name, boxes[:keep].numpy(), valid[:keep].numpy(), thr


CASES = list(_nms_cases()) + list(_adversarial_cases())


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_kernel_model_bit_equal_to_reference(case):
    name, boxes, valid, thr = case
    want = nms_mask_reference(torch.from_numpy(boxes), torch.from_numpy(valid), thr).numpy()
    total = {"pairs": 0, "divided": 0, "near_miss": 0, "rounds": 0}
    for b in range(boxes.shape[0]):
        # 32 warps as at N >= 1024, and 3 so that a warp owns several blocks
        for nwarps in (32, 3):
            got, stats = _kernel_model(boxes[b], valid[b], thr, nwarps)
            np.testing.assert_array_equal(got, want[b], err_msg=f"{name} image {b}")
        for key in total:
            total[key] += stats[key]
    if name == "near the threshold":
        # both sides of the threshold, and the band is exercised: some pairs
        # divide and still miss
        second = want[:, 1] | want[:, 40]
        assert second.any() and not second.all()
        assert total["near_miss"] > 0
    if name == "chain of 64 neighbours":
        assert want[0].tolist() == [True, False] * 32
        assert total["rounds"] >= 2 * 17               # the longest in-block chains
    if name == "1024 copies of one box":
        assert int(want.sum()) == 1
    if name in ("multiblock", "class_offset", "N=2048 B=8"):
        # the multiplication decides nearly every pair
        assert 0 < total["divided"] < 0.2 * total["pairs"]
    if name.startswith("threshold 0"):
        assert total["divided"] == total["pairs"]


def test_filter_never_drops_a_hit():
    """Pairs below thr * (1 - 2^-20) * union have a rounded quotient <= thr;
    random intersecting pairs, and unions scaled to sit at the threshold."""
    rng = np.random.default_rng(11)
    for thr in (0.6, 0.5, 0.2, 1e-3, 2.0 ** -20, 0.999):
        thr = F(thr)
        uni = rng.uniform(1e-3, 1e10, 200000).astype(F)
        # inter within a few hundred float32 steps of thr * union, both sides
        inter = (thr * uni).astype(F)
        steps = rng.integers(-300, 300, uni.size).astype(np.int32)
        inter = (inter.view(np.int32) + steps).view(F)
        below = inter < (thr * BELOW) * uni
        over = inter / uni > thr
        assert not (below & over).any()
        assert below.any() and over.any() and (~below & ~over).any()


@pytest.mark.parametrize("b,n,classes", [(1, 2048, 3), (2, 1000, 3), (2, 33, 0)])
def test_reference_bit_exact_vs_pallas_interpret_large_and_ragged(b, n, classes):
    rng = np.random.default_rng(n)
    boxes = sorted_boxes(rng, b, n, spread=300.0, classes=classes)
    valid = rng.uniform(size=(b, n)) > 0.15
    want = np.asarray(pallas_nms_mask_batched(jnp.asarray(boxes), jnp.asarray(valid),
                                              0.6, interpret=True))
    got = nms_mask_batched(torch.from_numpy(boxes), torch.from_numpy(valid), 0.6).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()


def test_nms_batched_2048_candidates_matches_jax():
    """Four levels x pre_nms_topk 512 = 2048 candidates, ``nms_topk`` 0 or 2048."""
    rng = np.random.default_rng(5)
    boxes = sorted_boxes(rng, 1, 2048, spread=500.0, classes=3)
    scores = rng.uniform(0.01, 1.0, size=(1, 2048)).astype(np.float32)
    want = jax_nms_batched(jnp.asarray(boxes), jnp.asarray(scores), 0.6,
                           max_outputs=64, score_threshold=0.05, interpret=True)
    got = nms_batched(torch.from_numpy(boxes), torch.from_numpy(scores), 0.6,
                      max_outputs=64, score_threshold=0.05)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _greedy_oracle(boxes, valid, thr):
    """Greedy NMS in float32 numpy, one kept box at a time against the later
    boxes still alive; the IoU rounded as the kernel and the JAX kernel do."""
    n = boxes.shape[0]
    alive = valid.copy()
    keep = np.zeros(n, bool)
    for i in range(n):
        if not alive[i]:
            continue
        keep[i] = True
        inter, uni = _inter_union(boxes[i:i + 1], boxes[i + 1:])
        alive[i + 1:] &= ~(inter[:, 0] / uni[:, 0] > F(thr))
    return keep


def test_reference_past_the_shared_size_matches_greedy_oracle():
    """N = 8320 (past ``SHARED_MAX_N``, no multiple of 128), one image of
    sparse boxes with clusters: the plain version, which the kernel's
    device-memory variant is held to on the card, equals greedy NMS."""
    rng = np.random.default_rng(83)
    n = 8320
    boxes = sorted_boxes(rng, 1, n, spread=4000.0, classes=3)[0]
    valid = rng.uniform(size=n) > 0.2
    want = _greedy_oracle(boxes, valid, 0.6)
    got = nms_mask_reference(torch.from_numpy(boxes)[None], torch.from_numpy(valid)[None], 0.6)
    np.testing.assert_array_equal(got[0].numpy(), want)
    assert 0.2 * n < want.sum() < valid.sum()


def test_cuda_wrapper_contract():
    # the switch point: past it the kernel keeps its per-box state in device
    # memory, and any N runs
    assert SHARED_MAX_N == 8192
    boxes = torch.zeros(1, 8, 4)
    with pytest.raises(ValueError, match="CUDA"):
        nms_mask_cuda(boxes, torch.ones(1, 8, dtype=torch.bool))
