"""The port's top-k threshold and selection against the JAX package.

``topk_threshold_reference`` (the plain version that ``csrc/topk.cu`` is held
to) must equal the Pallas ``_threshold_kernel`` in interpret mode to the bit,
on every case of ``tests/unit/test_topk.py`` (random (n, k), ties, ``k == n``
and the large-magnitude snap case) and on the edge cases of the kernel's
domain: signed zeros at the k-th position (compared by value: the search's
``min`` does not fix which zero it returns), an all-equal vector, k = 1,
k = N, and a geometric spread from 1e-30 to 1e30 that takes the search six
rounds. Subnormal scores are the one exception: XLA on the CPU flushes them
to zero, so there the Pallas kernel is held to the plain version on the
flushed vector, and the plain version on the raw one to ``np.sort``.

``_radix_select`` is a numpy model of the CUDA kernel's digit passes (keys,
11/11/10-bit histograms, the bin holding the k-th key, the count above); it
is held to the plain version on every case. ``topk_mask`` and ``topk`` are
exact too.
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


def _signed_zeros():
    s = np.array([0.0, -0.0, 2.0, -0.0, 0.0, -1.0, 3.0, -0.0, 0.0, -2.0], np.float32)
    return np.tile(s, 5)


def _subnormals():
    rng = np.random.default_rng(6)
    s = (rng.uniform(1, 100, 400) * np.float32(1e-40)).astype(np.float32)
    s[::3] *= -1
    return np.concatenate([s, rng.normal(0, 1, 100).astype(np.float32)])


def _geometric():
    s = np.geomspace(1e-30, 1e30, 3000).astype(np.float32)
    np.random.default_rng(7).shuffle(s)
    return s


CASES = {
    "n100_k10": (_random(100, 0), 10),
    "n1000_k100": (_random(1000, 1), 100),
    "n5000_k1000": (_random(5000, 2), 1000),
    "n64_k64": (_random(64, 3), 64),            # k == n
    "ties_k4": (TIES, 4),
    "snap_k3": (SNAP, 3),                       # needs the verify-and-restart round
    "coarse_ties_k37": (np.round(_random(300, 4) * 4) / 4, 37),
    "signed_zeros_k20": (_signed_zeros(), 20),  # the k-th largest is a zero
    "subnormals_k200": (_subnormals(), 200),    # the k-th largest is subnormal
    "n500_k1": (_random(500, 8), 1),
    "n500_k500": (_random(500, 9), 500),        # k == n
    "all_equal_k17": (np.full(100, -0.37, np.float32), 17),
    "geometric_k2999": (_geometric(), 2999),    # six rounds of the search
}
BY_VALUE = {"signed_zeros_k20"}
FLUSHED = {"subnormals_k200"}                   # XLA on the CPU flushes subnormals


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _flush(s):
    return np.where(np.abs(s) < np.finfo(np.float32).tiny, np.float32(0), s).astype(np.float32)


def _radix_select(s, k):
    """numpy model of ``csrc/topk.cu``: order-preserving keys (-0.0 as +0.0),
    then passes of 11, 11 and 10 bits, most significant first; each pass
    histograms the digit of the keys that match the prefix so far, takes the
    bin of the rank-th key from the top and adds the higher bins' counts to
    the count above. Returns (kth float32, n_above int)."""
    u = np.asarray(s, np.float32).reshape(-1).view(np.uint32).copy()
    u[u == np.uint32(0x80000000)] = 0
    key = np.where(u >> 31 == 1, ~u, u | np.uint32(0x80000000)).astype(np.uint32)
    prefix, above, rank = 0, 0, k
    for shift, width in ((21, 11), (10, 11), (0, 10)):
        top = shift + width
        cand = key if top == 32 else key[(key >> np.uint32(top)) == prefix]
        digit = (cand >> np.uint32(shift)) & np.uint32((1 << width) - 1)
        hist = np.bincount(digit, minlength=1 << width)
        at_or_above = np.cumsum(hist[::-1])[::-1]      # keys with this digit or a higher one
        d = int(np.nonzero(at_or_above >= rank)[0].max())
        higher = int(at_or_above[d] - hist[d])
        above += higher
        rank -= higher
        prefix = (prefix << width) | d
    bits = prefix & 0x7FFFFFFF if prefix >> 31 else ~prefix & 0xFFFFFFFF
    return np.uint32(bits).view(np.float32), above


def _same(a, b, case):
    if case in BY_VALUE:
        return float(a) == float(b)
    return _bits(a) == _bits(b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_threshold_reference_bit_equal_to_pallas(case):
    s, k = CASES[case]
    want_kth, want_cnt = pallas_topk_threshold(jnp.asarray(s), k, interpret=True)
    kth, cnt = topk_threshold_reference(torch.from_numpy(s), k)
    if case in FLUSHED:
        # the Pallas kernel saw the subnormals as zeros; the plain version
        # on the flushed vector agrees with it (by value: a flushed zero
        # may carry either sign)
        kth_f, cnt_f = topk_threshold_reference(torch.from_numpy(_flush(s)), k)
        assert float(kth_f) == float(want_kth) and int(cnt_f) == int(want_cnt)
        assert float(kth) != 0.0 and abs(float(kth)) < np.finfo(np.float32).tiny
    else:
        assert _same(kth.numpy(), want_kth, case), case
        assert int(cnt) == int(want_cnt)
    assert cnt.dtype == torch.int32
    # the device-dispatching entry point takes the plain version for a CPU tensor
    kth2, cnt2 = topk_threshold(torch.from_numpy(s), k)
    assert _bits(kth2.numpy()) == _bits(kth.numpy()) and int(cnt2) == int(cnt)
    assert float(kth) == np.sort(s)[::-1][k - 1]
    assert int(cnt) == int((s > np.sort(s)[::-1][k - 1]).sum())


@pytest.mark.parametrize("case", sorted(CASES))
def test_radix_select_model_matches_reference(case):
    """The kernel's digit logic, rehearsed in numpy: equal to the plain
    version on every case (by value where the k-th largest is a zero)."""
    s, k = CASES[case]
    kth, cnt = topk_threshold_reference(torch.from_numpy(s), k)
    got, above = _radix_select(s, k)
    assert above == int(cnt), case
    if float(kth) == 0.0:
        assert float(got) == 0.0 and _bits(got) == 0      # the kernel returns +0.0
    else:
        assert _bits(got) == _bits(kth.numpy()), case


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
