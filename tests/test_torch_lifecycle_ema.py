"""The tracker's appearance update and the ReID head's normalization against
the JAX package, bit for bit.

``lifecycle.apply_matches`` blends each matched slot's embedding with its
detection's (an EMA) and L2-normalizes it. XLA fuses that update, contracts
its multiply-adds and reduces the squares in a width-dependent order; the
port's ``ema_normalize`` writes the same arithmetic out
(``waymo_2d_tracking_tpu_torch/tracker/lifecycle.py``). Random inputs, made
with numpy from a seed, go through ``jax.jit(lifecycle.apply_matches)`` (under
``jax.vmap`` for a camera axis) and the port's ``apply_matches`` on the CPU;
the ``embed`` outputs must be equal bit for bit. The ReID head ends in the
same ``jnp.linalg.norm``: its normalization, fed the jitted JAX head's own
projection output, must give the head's embeddings bit for bit
(``utils/l2norm.py l2_normalize``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waymo_2d_tracking_tpu.config import TrackerConfig as JaxTrackerConfig
from waymo_2d_tracking_tpu.tracker import lifecycle as jlifecycle
from waymo_2d_tracking_tpu.tracker.tracker import init_state as jax_init_state
from waymo_2d_tracking_tpu.types import Detections as JaxDetections

from waymo_2d_tracking_tpu_torch.config import TrackerConfig
from waymo_2d_tracking_tpu_torch.tracker import lifecycle
from waymo_2d_tracking_tpu_torch.types import Detections, TrackerState
from waymo_2d_tracking_tpu_torch.utils import l2norm

torch.set_num_threads(1)


def _unit(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _inputs(rng, s, d, e, k=4):
    """One camera's state and detections: unit embeddings, a few slots
    unmatched and a few with their appearance update masked off."""
    kw = dict(max_tracks=s, max_detections=d, embed_dim=e, gallery_size=k,
              reid_recovery=True)
    state = jax.device_get(jax_init_state(JaxTrackerConfig(**kw)))
    state = dataclasses.replace(
        state, embed=_unit(rng, (s, e)), status=np.full((s,), 2, np.int8),
        gallery=_unit(rng, (s, k, e)),
        gallery_count=rng.integers(0, 9, s).astype(np.int32))
    xy = rng.uniform(0, 500, (d, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(10, 80, (d, 2)).astype(np.float32)], -1)
    dets = JaxDetections(
        boxes=boxes, scores=rng.uniform(0, 1, d).astype(np.float32),
        classes=np.zeros(d, np.int32), embeds=_unit(rng, (d, e)),
        valid=np.ones(d, bool))
    row_to_col = rng.permutation(d)[:s].astype(np.int32)
    row_to_col[rng.random(s) < 0.15] = -1
    embed_update = rng.random(s) > 0.2
    return kw, state, dets, row_to_col, embed_update


def _stack(records):
    return jax.tree.map(lambda *x: np.stack(x), *records)


@pytest.mark.parametrize("cams,s,e,ema", [
    (None, 64, 128, 0.9),
    (5, 64, 128, 0.9),
    (None, 64, 64, 0.9),
    (None, 256, 256, 0.9),
    (None, 64, 128, 0.75),
    (None, 64, 32, 0.9),
    (5, 16, 32, 0.9),
    (None, 16, 16, 0.9),
    (None, 64, 8, 0.8),
])
def test_apply_matches_embed_bit_equal_to_jit(cams, s, e, ema):
    rng = np.random.default_rng(7 + e + s)
    cases = [_inputs(rng, s, s, e) for _ in range(cams or 1)]
    kw = dict(cases[0][0], embed_ema=ema)
    jcfg, cfg = JaxTrackerConfig(**kw), TrackerConfig(**kw)

    def jax_step(state, dets, r2c, upd):
        return jlifecycle.apply_matches(state, dets, r2c, jnp.zeros_like(upd), jcfg,
                                        embed_update=upd)

    if cams is None:
        _, state, dets, r2c, upd = cases[0]
        want = jax.jit(jax_step)(state, dets, r2c, upd)
    else:
        state, dets, r2c, upd = (_stack([c[i] for c in cases]) for i in range(1, 5))
        want = jax.jit(jax.vmap(jax_step))(state, dets, r2c, upd)
    up = torch.from_numpy(upd)
    got = lifecycle.apply_matches(
        TrackerState.from_numpy(state), Detections.from_numpy(dets),
        torch.from_numpy(r2c), torch.zeros_like(up), cfg, embed_update=up)
    np.testing.assert_array_equal(got.embed.numpy(), np.asarray(want.embed))
    np.testing.assert_array_equal(got.gallery.numpy(), np.asarray(want.gallery))
    # the masked and the unmatched slots kept their embeddings
    keep = (r2c < 0) | ~upd
    np.testing.assert_array_equal(got.embed.numpy()[keep], state.embed[keep])


@pytest.mark.parametrize("e,rois", [(128, 64), (128, 7), (64, 256), (32, 64), (16, 5)])
def test_reid_head_normalization_bit_equal_to_jit(e, rois):
    from waymo_2d_tracking_tpu.models.reid import ReIDHead as JaxReIDHead

    rng = np.random.default_rng(e + rois)
    head = JaxReIDHead(embed_dim=e, channels=32, dtype=jnp.float32)
    pooled = rng.normal(size=(rois, 7, 7, 16)).astype(np.float32)
    variables = head.init(jax.random.PRNGKey(0), pooled)

    @jax.jit
    def run(v, x):
        return head.apply(v, x, capture_intermediates=lambda mdl, _: mdl.name == "proj")

    want, state = run(variables, pooled)
    proj = np.asarray(state["intermediates"]["proj"]["__call__"][0])
    got = l2norm.l2_normalize(torch.from_numpy(proj))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
