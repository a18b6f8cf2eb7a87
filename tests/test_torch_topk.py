"""The port's top-k threshold and selection against the JAX package.

``topk_threshold_reference`` (the plain version of ``csrc/topk.cu``) must
equal the Pallas ``_threshold_kernel`` in interpret mode to the bit, on every
case of ``tests/unit/test_topk.py``: random (n, k), ties, ``k == n`` and the
large-magnitude snap case. ``topk_mask`` and ``topk`` are exact too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waymo_2d_tracking_tpu.ops.topk import pallas_topk_threshold
from waymo_2d_tracking_tpu.ops.topk import topk as jax_topk
from waymo_2d_tracking_tpu.ops.topk import topk_mask as jax_topk_mask

from waymo_2d_tracking_tpu_torch.ops.topk import (
    topk,
    topk_mask,
    topk_threshold,
    topk_threshold_cuda,
    topk_threshold_reference,
)

# xdist runs several workers on the machine's cores; a torch thread pool the
# width of the machine in each would oversubscribe them, and the port's CPU
# ops are small, so one thread each is fastest.
torch.set_num_threads(1)

TIES = np.array([5.0, 3.0, 5.0, 5.0, 1.0, 3.0, 0.0, 2.0], np.float32)
SNAP = np.array([1e9, -1e9, 0.0, 1e-4, 1e-4, -3e8, 2e8], np.float32)


def _random(n, seed):
    return np.random.default_rng(seed).normal(0, 1, n).astype(np.float32)


CASES = {
    "n100_k10": (_random(100, 0), 10),
    "n1000_k100": (_random(1000, 1), 100),
    "n5000_k1000": (_random(5000, 2), 1000),
    "n64_k64": (_random(64, 3), 64),            # k == n
    "ties_k4": (TIES, 4),
    "snap_k3": (SNAP, 3),                       # needs the verify-and-restart round
    "coarse_ties_k37": (np.round(_random(300, 4) * 4) / 4, 37),
}


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_threshold_reference_bit_equal_to_pallas(case):
    s, k = CASES[case]
    want_kth, want_cnt = pallas_topk_threshold(jnp.asarray(s), k, interpret=True)
    kth, cnt = topk_threshold_reference(torch.from_numpy(s), k)
    assert _bits(kth.numpy()) == _bits(want_kth), case
    assert int(cnt) == int(want_cnt) and cnt.dtype == torch.int32
    # the device-dispatching entry point takes the plain version for a CPU tensor
    kth2, cnt2 = topk_threshold(torch.from_numpy(s), k)
    assert _bits(kth2.numpy()) == _bits(kth.numpy()) and int(cnt2) == int(cnt)
    assert float(kth) == np.sort(s)[::-1][k - 1]


@pytest.mark.parametrize("shape,k,seed", [((8,), 4, None), ((7,), 3, "snap"),
                                          ((32, 64), 10, 2), ((2048,), 256, 1),
                                          ((16, 12), 50, "coarse")])
def test_topk_mask_equals_jax(shape, k, seed):
    if seed is None:
        s = TIES
    elif seed == "snap":
        s = SNAP
    elif seed == "coarse":
        s = (np.round(_random(192, 5) * 2) / 2).reshape(shape).astype(np.float32)
    else:
        s = _random(int(np.prod(shape)), seed).reshape(shape)
    want = np.asarray(jax_topk_mask(jnp.asarray(s), k, interpret=True))
    got = topk_mask(torch.from_numpy(s), k).numpy()
    assert got.shape == s.shape and got.sum() == k
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method", ["exact", "approx"])
def test_topk_equals_lax_top_k(method):
    rng = np.random.default_rng(3)
    for s in (rng.normal(0, 1, 4096).astype(np.float32),
              (np.round(rng.normal(0, 1, (24, 40)) * 3) / 3).astype(np.float32)):
        want_v, want_i = jax_topk(jnp.asarray(s), 128, method=method)
        want_v2, want_i2 = jax.lax.top_k(jnp.asarray(s.reshape(-1)), 128)
        got_v, got_i = topk(torch.from_numpy(s), 128, method=method)
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i2))


def test_contract_errors():
    s = torch.from_numpy(_random(10, 0))
    with pytest.raises(ValueError, match="k=11 > n=10"):
        topk_threshold_reference(s, 11)
    with pytest.raises(ValueError, match="method"):
        topk(s, 3, method="bucketed")
    with pytest.raises(ValueError, match="CUDA"):
        topk_threshold_cuda(s[None].contiguous(), 3)
