"""The port's training losses and targets (``train/losses.py``,
``models/centernet.py``'s training half) against the JAX package on the same
numpy inputs, float32 on the CPU: integer targets exact, float targets and
losses rtol 1e-5, and their autograd gradients against ``jax.grad`` within
rtol 1e-5 (atol 1e-6 of the gradient's largest magnitude: sums over
thousands of locations round in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waymo_2d_tracking_tpu.models import centernet as jcn
from waymo_2d_tracking_tpu.train import losses as jl

from waymo_2d_tracking_tpu_torch.models import centernet as pcn
from waymo_2d_tracking_tpu_torch.train import losses as pl

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _grad_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * max(np.abs(want).max(), 1e-6))


def _gt(seed, n=2, g=7, hw=(64, 96)):
    """Random GT with duplicates (equal areas: the argmin tie order),
    boxes on location centres, degenerate and invalid entries."""
    rng = np.random.default_rng(seed)
    h, w = hw
    x1 = rng.uniform(-10, w - 8, (n, g))
    y1 = rng.uniform(-10, h - 8, (n, g))
    bw = rng.choice([8.0, 16.0, 40.0, 90.0, 300.0], (n, g))
    bh = rng.choice([8.0, 16.0, 40.0, 90.0], (n, g))
    boxes = np.stack([x1, y1, x1 + bw, y1 + bh], -1).astype(np.float32)
    boxes[:, 1] = boxes[:, 0]                       # an exact duplicate
    boxes[:, 2] = [4.0, 4.0, 20.0, 36.0]            # edges on location centres
    boxes[:, 3, 2] = boxes[:, 3, 0]                 # zero width
    classes = rng.integers(0, 3, (n, g)).astype(np.int32)
    valid = rng.uniform(size=(n, g)) < 0.85
    valid[:, :3] = True
    return boxes, classes, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("lvl", [3, 4, 5])
def test_assign_targets_level_match_jax(seed, lvl):
    boxes, classes, valid = _gt(seed)
    h, w = 64 // 2 ** lvl, 96 // 2 ** lvl
    locs_j = jl.level_locations(h, w, 2 ** lvl)
    locs_p = pl.level_locations(h, w, 2 ** lvl)
    np.testing.assert_array_equal(locs_p.numpy(), np.asarray(locs_j))
    want = jax.vmap(lambda b, c, v: jl.assign_targets_level(
        locs_j, b, c, v, jl.LEVEL_RANGES[lvl]))(boxes, classes, valid)
    got = pl.assign_targets_level(locs_p, _t(boxes), _t(classes), _t(valid), pl.LEVEL_RANGES[lvl])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-6, atol=1e-7)


def test_elementwise_losses_and_gradients_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 4, (64, 3)).astype(np.float32)
    logits[0] = [0.0, 30.0, -30.0]
    labels = (rng.uniform(size=(64, 3)) < 0.3).astype(np.float32)
    for name, jf, pf in (("ce", jl.optax_sigmoid_ce, pl.optax_sigmoid_ce),
                         ("focal", jl.sigmoid_focal_loss, pl.sigmoid_focal_loss)):
        want, gw = jax.value_and_grad(lambda x: jnp.sum(jf(x, labels)))(logits)
        x = _t(logits).requires_grad_()
        got = pf(x, _t(labels)).sum()
        got.backward()
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5, err_msg=name)
        _grad_close(x.grad.numpy(), gw)
    # GIoU with degenerate predictions and targets (zero and negative
    # extents: the union and enclosing area clamp at 1e-6 as in JAX)
    pred = rng.uniform(0.5, 40, (64, 4)).astype(np.float32)
    tgt = rng.uniform(0.5, 40, (64, 4)).astype(np.float32)
    tgt[:4] = 0.0
    pred[4:6, :2] = 0.0
    pred[6] = [-2.0, 1.0, 1.0, -3.0]
    want, gw = jax.value_and_grad(lambda p: jnp.sum(jl.giou_loss(p, tgt)))(pred)
    x = _t(pred).requires_grad_()
    got = pl.giou_loss(x, _t(tgt))
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jl.giou_loss(pred, tgt)),
                               rtol=1e-5, atol=1e-6)
    _grad_close(x.grad.numpy(), gw)


def _head_out(seed, n=2, k=3, hw=(64, 96), levels=(3, 4, 5)):
    rng = np.random.default_rng(seed)
    out = {}
    for lvl in levels:
        h, w = hw[0] // 2 ** lvl, hw[1] // 2 ** lvl
        out[lvl] = (rng.normal(-2, 1.5, (n, h, w, k)).astype(np.float32),
                    np.exp(rng.normal(1.5, 0.6, (n, h, w, 4))).astype(np.float32),
                    rng.normal(0, 1, (n, h, w, 1)).astype(np.float32))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_fcos_loss_and_gradients_match_jax(seed):
    head = _head_out(seed)
    boxes, classes, valid = _gt(seed)

    def jloss(h):
        return jl.fcos_loss(h, boxes, classes, valid, num_classes=3)

    (loss_j, m_j), g_j = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {k: tuple(jnp.asarray(a) for a in v) for k, v in head.items()})
    leaves = {k: tuple(_t(a).requires_grad_() for a in v) for k, v in head.items()}
    loss_p, m_p = pl.fcos_loss(leaves, _t(boxes), _t(classes), _t(valid), num_classes=3)
    loss_p.backward()
    for key in m_j:
        np.testing.assert_allclose(float(m_p[key]), float(m_j[key]), rtol=1e-5, err_msg=key)
    for lvl in head:
        for a, b in zip(leaves[lvl], g_j[lvl]):
            _grad_close(a.grad.numpy(), b)


def test_reid_losses_and_gradients_match_jax():
    rng = np.random.default_rng(6)
    e = rng.normal(size=(3, 5, 8)).astype(np.float32)
    e /= np.linalg.norm(e, axis=-1, keepdims=True)
    ids = rng.integers(0, 4, (3, 5)).astype(np.int32)
    ids[0, 4] = -1
    valid = rng.uniform(size=(3, 5)) < 0.8
    cases = [
        (ids, valid),
        # tests/unit/test_reid_training.py's masked case: singletons and -1
        (np.array([[0, 0, 1, 5, 6], [2, -1, 3, 7, 8], [9, 10, 11, 12, 13]], np.int32),
         np.array([[1, 1, 1, 1, 1], [1, 1, 0, 1, 1], [1, 1, 1, 1, 1]], bool)),
        # degenerate: nothing valid, and one identity only (no negative)
        (np.full((3, 5), -1, np.int32), np.zeros((3, 5), bool)),
        (np.zeros((3, 5), np.int32), np.ones((3, 5), bool)),
    ]
    for i, (ids_c, valid_c) in enumerate(cases):
        for jf, pf, kw in ((jl.reid_triplet_loss, pl.reid_triplet_loss, {"margin": 0.3}),
                           (jl.reid_supcon_loss, pl.reid_supcon_loss, {"temperature": 0.1})):
            (lj, cj), gj = jax.value_and_grad(
                lambda x: jf(x, ids_c, valid_c, **kw), has_aux=True)(e)
            x = _t(e).requires_grad_()
            lp, cp = pf(x, _t(ids_c), _t(valid_c), **kw)
            assert int(cp) == int(cj), (i, jf.__name__)
            np.testing.assert_allclose(float(lp), float(lj), rtol=1e-5, atol=1e-7,
                                       err_msg=f"{i} {jf.__name__}")
            lp.backward()
            _grad_close(x.grad.numpy(), gj)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_centernet_targets_and_loss_match_jax(seed):
    boxes, classes, valid = _gt(seed)
    h, w, stride, k = 8, 12, 8, 3
    want = jax.vmap(lambda b, c, v: jcn.centernet_targets(b, c, v, h, w, stride, k))(
        boxes, classes, valid)
    got = pcn.centernet_targets(_t(boxes), _t(classes), _t(valid), h, w, stride, k)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    assert float(got[0].max()) == 1.0

    rng = np.random.default_rng(seed + 10)
    head = {3: (rng.normal(-2, 2, (2, h, w, k)).astype(np.float32),
                rng.normal(0, 1, (2, h, w, 2)).astype(np.float32),
                rng.uniform(-0.5, 0.5, (2, h, w, 2)).astype(np.float32))}
    (lj, mj), gj = jax.value_and_grad(
        lambda hh: jcn.centernet_loss(hh, boxes, classes, valid, num_classes=k),
        has_aux=True)({3: tuple(jnp.asarray(a) for a in head[3])})
    leaves = {3: tuple(_t(a).requires_grad_() for a in head[3])}
    lp, mp = pcn.centernet_loss(leaves, _t(boxes), _t(classes), _t(valid), num_classes=k)
    lp.backward()
    for key in mj:
        np.testing.assert_allclose(float(mp[key]), float(mj[key]), rtol=1e-5, err_msg=key)
    for a, b in zip(leaves[3], gj[3]):
        _grad_close(a.grad.numpy(), b)
    r_j = jcn.gaussian_radius(jnp.asarray([1.0, 5.0, 20.0]), jnp.asarray([2.0, 5.0, 3.0]))
    r_p = pcn.gaussian_radius(torch.tensor([1.0, 5.0, 20.0]), torch.tensor([2.0, 5.0, 3.0]))
    np.testing.assert_allclose(r_p.numpy(), np.asarray(r_j), rtol=1e-6)
