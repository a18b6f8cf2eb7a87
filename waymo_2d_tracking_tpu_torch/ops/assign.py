"""Linear assignment by eps-scaled auction (counterpart of ``ops/assign.py``).

``auction_assign`` dispatches like the JAX package does:

- a CUDA tensor builds the padded square benefit (``_build_benefit``) and
  launches the hand-written kernel ``csrc/auction.cu`` (it replaces the
  Pallas ``_auction_kernel``, which JAX runs on the TPU). The kernel itself
  skips problems with no feasible pair, so a tracker step never waits on
  the host;
- a CPU tensor runs the XLA while-loop schedule (``_auction_phase`` plus the
  final polish at ``eps_min``), which is what JAX runs off the TPU. The CPU
  goldens froze exact ids on that schedule.

``auction_kernel_reference`` is the plain PyTorch version of the kernel: the
same schedule, batched over problems. The tests and ``chip_smoke.py`` hold
the kernel and the Pallas kernel against it.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from waymo_2d_tracking_tpu_torch.ops import _cuda

_NEG_INF = -1e30  # only for masking bids within one iteration
_BIG = 1e30
WARP_MAX_N = 128  # up to it one warp a problem, the benefit in shared memory
MAX_N = 14400     # past WARP_MAX_N one CTA a problem, 16 B of shared memory a column


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def _round_up_128(x: int) -> int:
    """Static benefit side for the kernel: 64 up to 64x64, else multiples of 128."""
    if x <= 64:
        return 64
    return ((max(x, 128) + 127) // 128) * 128


def _build_benefit(cost: torch.Tensor, valid: torch.Tensor, n_out: int,
                   eps_min: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Square padded maximization benefit + dynamic eps0 for the auction.

    cost / valid (..., R, C): leading axes are independent problems (cameras),
    each reduced on its own. Returns (benefit (..., n_out, n_out) f32, eps0
    (...,) f32). Padding is worse than any chain of valid assignments
    (maximum cardinality wins) by only the needed margin; a row-rotated
    nudge of (n-1)*tiny < eps_min/4 breaks exact ties so uniform blocks
    resolve in one round. Scalars enter as Python numbers, never as new
    device tensors: building a tensor from a host value on the card would
    wait for the stream once per tracker step.
    """
    r, c = cost.shape[-2:]
    lead = cost.shape[:-2]
    dev = cost.device
    costf = cost.float()
    masked = torch.where(valid, costf, 0.0)
    c_max = torch.clamp(masked.amax(dim=(-2, -1)), min=0.0)
    c_min = torch.clamp(masked.amin(dim=(-2, -1)), max=0.0)
    pad = -((c_max - c_min) * float(n_out) + 1.0) + c_min

    benefit = torch.zeros(lead + (n_out, n_out), dtype=torch.float32, device=dev)
    benefit[..., :r, :c] = torch.where(valid, -costf, 0.0)
    mask_nn = torch.zeros(lead + (n_out, n_out), dtype=torch.bool, device=dev)
    mask_nn[..., :r, :c] = valid
    benefit = torch.where(mask_nn, benefit, pad[..., None, None])

    idx = torch.arange(n_out, dtype=torch.float32, device=dev)
    rot = torch.remainder(idx[None, :] - idx[:, None], float(n_out))
    # float32(eps_min) / (4 n) rounded in float32, as JAX computes it
    tiny = float(np.float32(eps_min) / np.float32(4.0 * n_out))
    benefit = benefit - rot * tiny

    brange = (c_max - pad) - c_min
    eps0 = torch.clamp(brange * 0.5, min=eps_min)
    return benefit, eps0


def _auction_phase(benefit: np.ndarray, prices: np.ndarray, eps: np.float32,
                   max_iters: int) -> Tuple[np.ndarray, np.ndarray]:
    """One eps phase of the XLA while-loop auction (JAX ``_auction_phase``),
    all rows live, in float32 numpy. Returns (row_to_col (N,) int32, prices)."""
    n = benefit.shape[0]
    idx = np.arange(n)
    neg = np.float32(_NEG_INF)
    row_to_col = np.full((n,), -1, dtype=np.int32)
    owner = np.full((n,), -1, dtype=np.int64)
    p = prices
    it = 0
    # The (rows x cols) bid grid of the JAX code is reduced here with
    # scatters over each row's best column; the winner is the lowest row
    # among equal best bids, as argmax over the grid picks it.
    while it < max_iters and (row_to_col < 0).any():
        unassigned = row_to_col < 0
        v = benefit - p[None, :]
        j_best = v.argmax(axis=1)            # first index among equal maxima
        v1 = v[idx, j_best]
        v[idx, j_best] = neg
        v2 = v.max(axis=1)
        bid_price = p[j_best] + (v1 - v2) + eps

        cand = np.where(unassigned, bid_price, neg)
        col_best_bid = np.full((n,), neg, dtype=np.float32)
        np.maximum.at(col_best_bid, j_best, cand)
        winner_rows = np.where(cand == col_best_bid[j_best], idx, n)
        col_winner = np.full((n,), n, dtype=np.int64)
        np.minimum.at(col_winner, j_best, winner_rows)
        has_bid = col_best_bid > neg * np.float32(0.5)

        p = np.where(has_bid, col_best_bid, p)
        owner = np.where(has_bid, col_winner, owner)
        # rebuild row -> col from ownership (max column, as the scatter-max)
        owned = owner >= 0
        row_to_col = np.full((n,), -1, dtype=np.int32)
        np.maximum.at(row_to_col, owner[owned], idx[owned].astype(np.int32))
        it += 1
    return row_to_col, p


def _auction_while_loop(benefit, eps0, eps_scale, eps_min, max_iters):
    """The JAX XLA-path schedule: phases while eps > eps_min, then a polish.

    It runs only for CPU tensors, where each bidding round is a handful of
    tiny array operations: numpy does them several times faster than torch's
    dispatcher, with the same float32 rounding."""
    b = benefit.numpy()
    prices = np.zeros((b.shape[0],), dtype=np.float32)
    eps = np.float32(eps0.item())
    eps_min_f = np.float32(eps_min)
    while eps > eps_min_f:
        _, prices = _auction_phase(b, prices, eps, max_iters)
        eps = max(eps * np.float32(eps_scale), eps_min_f * np.float32(0.5))
    row_to_col, _ = _auction_phase(b, prices, eps_min_f, max_iters)
    return torch.from_numpy(row_to_col)


def auction_kernel_reference(
    benefit: torch.Tensor, eps0: torch.Tensor, feasible: torch.Tensor, *,
    eps_scale: float, eps_min: float, max_iters: int,
):
    """Plain PyTorch version of ``csrc/auction.cu`` (the Pallas kernel's
    schedule), batched: benefit (P, n, n) f32, eps0 (P,) f32, feasible (P,)
    bool. Returns (row_to_col (P, n) int32, rounds (P,) int64, bids (P,)
    int64, bidders (P, n + 1) int64): the bidding rounds each problem ran,
    the bids its unassigned rows made over them (the data-dependent work,
    used for the kernel's bound) and how many of its rounds had 0..n
    bidders. Problems run in lockstep, each masked out once its own loop has
    ended."""
    pn, n, _ = benefit.shape
    dev = benefit.device
    cols = torch.arange(n, dtype=torch.int32, device=dev)
    big = _f32(_BIG, dev)
    eps_min_t = _f32(eps_min, dev)
    eps_stop = _f32(eps_min * 1.000001, dev)
    prices = torch.zeros((pn, n), dtype=torch.float32, device=dev)
    rtc = torch.full((pn, n), -1, dtype=torch.int32, device=dev)
    rounds = torch.zeros((pn,), dtype=torch.int64, device=dev)
    bids_made = torch.zeros((pn,), dtype=torch.int64, device=dev)
    bidders = torch.zeros((pn, n + 1), dtype=torch.int64, device=dev)
    eps = eps0.float().clone()
    outer = feasible.bool() & (eps > 0)
    while bool(outer.any()):
        e = torch.maximum(eps, eps_min_t)
        rtc = torch.where(outer[:, None], -1, rtc)
        owner = torch.full((pn, n), -1, dtype=torch.int32, device=dev)
        inner = outer.clone()
        it = 0
        while True:
            inner = inner & (rtc < 0).any(dim=1) & (it < max_iters)
            if not bool(inner.any()):
                break
            v = benefit - prices[:, None, :]                           # (P, n, n)
            v1 = v.amax(dim=2, keepdim=True)
            jbest = torch.where(v >= v1, cols, n).amin(dim=2)    # (P, n)
            onehot = cols[None, None, :] == jbest[..., None]
            v2 = torch.where(onehot, -big, v).amax(dim=2)
            b_best = torch.gather(benefit, 2, jbest[..., None].long())[..., 0]
            bid = (b_best - v2) + e[:, None]
            unassigned = (rtc < 0) & inner[:, None]
            bids = torch.where(onehot & unassigned[..., None], bid[..., None], -big)
            col_best = bids.amax(dim=1)                          # (P, n)
            winner = torch.where(bids >= col_best[:, None, :], cols[None, :, None],
                                 n).amin(dim=1)
            has_bid = col_best > -big * 0.5
            prices = torch.where(has_bid, col_best, prices)
            owner = torch.where(has_bid, winner, owner)
            owns = owner[:, None, :] == cols[None, :, None]            # (P, row, col)
            new_rtc = torch.where(owns, cols, n).amin(dim=2)
            new_rtc = torch.where(new_rtc >= n, -1, new_rtc)
            rtc = torch.where(inner[:, None], new_rtc, rtc)
            rounds += inner.long()
            bids_made += unassigned.sum(dim=1)
            bidders.scatter_add_(1, unassigned.sum(dim=1, keepdim=True), inner.long()[:, None])
            it += 1
        next_eps = torch.where(e <= eps_stop, torch.zeros_like(eps), eps * eps_scale)
        eps = torch.where(outer, next_eps, eps)
        outer = outer & (eps > 0)
    rtc = torch.where(feasible.bool()[:, None], rtc, -1)
    return rtc.to(torch.int32), rounds, bids_made, bidders


def auction_kernel_cuda(
    benefit: torch.Tensor, eps0: torch.Tensor, feasible: torch.Tensor, *,
    eps_scale: float, eps_min: float, max_iters: int,
) -> torch.Tensor:
    """Launch ``csrc/auction.cu`` on a batch: benefit (P, n, n) f32 with n a
    multiple of 32 up to ``MAX_N``, eps0 (P,) f32, feasible (P,) bool, all
    contiguous on one CUDA device. Returns row_to_col (P, n) int32. Up to
    ``WARP_MAX_N`` one warp per problem, several problems per CTA when P
    exceeds the SM count; above it one CTA per problem reading the benefit
    from device memory."""
    dev = benefit.device
    if dev.type != "cuda" or eps0.device != dev or feasible.device != dev:
        raise ValueError("auction_kernel_cuda takes CUDA tensors on one device")
    if benefit.dtype != torch.float32 or eps0.dtype != torch.float32 \
            or feasible.dtype != torch.bool:
        raise TypeError("benefit and eps0 must be float32, feasible bool")
    if benefit.dim() != 3 or benefit.shape[1] != benefit.shape[2]:
        raise ValueError(f"benefit must be (P, n, n), got {tuple(benefit.shape)}")
    pn, n, _ = benefit.shape
    if eps0.shape != (pn,) or feasible.shape != (pn,):
        raise ValueError("eps0 and feasible must be (P,)")
    if n > MAX_N or n % 32:
        raise ValueError(f"the auction kernel takes n in 32..{MAX_N} step 32, got {n}")
    if not (benefit.is_contiguous() and eps0.is_contiguous() and feasible.is_contiguous()):
        raise ValueError("benefit, eps0 and feasible must be contiguous")
    if benefit.data_ptr() % 16:
        raise ValueError("benefit must start on a 16-byte boundary (the kernel reads float4)")
    out = torch.empty((pn, n), dtype=torch.int32, device=dev)
    lib = _cuda.library("auction")
    with torch.cuda.device(dev):
        err = lib.w2t_auction(
            ctypes.c_void_p(benefit.data_ptr()), ctypes.c_void_p(eps0.data_ptr()),
            ctypes.c_void_p(feasible.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            ctypes.c_int(pn), ctypes.c_int(n), ctypes.c_float(eps_scale),
            ctypes.c_float(eps_min), ctypes.c_float(eps_min * 1.000001),
            ctypes.c_int(max_iters), ctypes.c_void_p(_cuda.stream_handle(dev)),
        )
    _cuda.check(err, "auction")
    auction_kernel_cuda.launches += 1
    auction_kernel_cuda.last_shape = (pn, n)
    return out


auction_kernel_cuda.launches = 0
auction_kernel_cuda.last_shape = None  # (P, n) of the last launch


def _valid_pairs(cost, row_mask, col_mask, forbid):
    """(..., R, C) bool: pairs of a valid row and a valid column, not forbidden."""
    shape, dev = cost.shape, cost.device
    if row_mask is None:
        row_mask = torch.ones(shape[:-1], dtype=torch.bool, device=dev)
    if col_mask is None:
        col_mask = torch.ones(shape[:-2] + shape[-1:], dtype=torch.bool, device=dev)
    valid = row_mask[..., :, None] & col_mask[..., None, :]
    if forbid is not None:
        valid = valid & ~forbid
    return valid


def greedy_assign(
    cost: torch.Tensor,
    row_mask: Optional[torch.Tensor] = None,
    col_mask: Optional[torch.Tensor] = None,
    forbid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy lowest-cost-first matching (not optimal). Same contract as
    :func:`auction_assign`, leading axes included: each problem takes its own
    cheapest pair per step. Runs min(R, C) masked steps with no host sync; a
    step with no valid pair left changes nothing, as the JAX early exit."""
    r, c = cost.shape[-2:]
    lead = cost.shape[:-2]
    dev = cost.device
    valid = _valid_pairs(cost, row_mask, col_mask, forbid)
    work = torch.where(valid, cost.float(), _BIG)
    rtc = torch.full(lead + (r,), -1, dtype=torch.int32, device=dev)
    ctr = torch.full(lead + (c,), -1, dtype=torch.int32, device=dev)
    rows = torch.arange(r, device=dev)
    cols = torch.arange(c, device=dev)
    for _ in range(min(r, c)):
        flat_work = work.flatten(-2)
        live = (flat_work.amin(dim=-1) < _BIG * 0.5)[..., None]
        flat = torch.argmin(flat_work, dim=-1)[..., None]
        i, j = flat // c, flat % c
        rtc = torch.where((rows == i) & live, j.to(torch.int32), rtc)
        ctr = torch.where((cols == j) & live, i.to(torch.int32), ctr)
        hit = ((rows == i)[..., :, None] | (cols == j)[..., None, :]) & live[..., None]
        work = torch.where(hit, _BIG, work)
    return rtc, ctr


def auction_assign(
    cost: torch.Tensor,
    row_mask: Optional[torch.Tensor] = None,
    col_mask: Optional[torch.Tensor] = None,
    forbid: Optional[torch.Tensor] = None,
    *,
    eps_scale: float = 0.2,
    eps_min: float = 1e-3,
    max_iters: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Min-cost assignment of rows to columns.

    cost (..., R, C) f32; row_mask (..., R) / col_mask (..., C) bool, False
    entries are padding; forbid (..., R, C) bool gates pairs. Leading axes
    are independent problems (the cameras of a rig): on the card they are
    one kernel launch, ``P`` = their product. Returns (row_to_col (..., R)
    int32, col_to_row (..., C) int32), -1 for unmatched; pairs routed
    through padding or forbidden entries are reported unmatched. Total cost
    is within N * eps_min of optimal.
    """
    r, c = cost.shape[-2:]
    lead = cost.shape[:-2]
    dev = cost.device
    valid = _valid_pairs(cost, row_mask, col_mask, forbid)

    if dev.type == "cuda":
        n = _round_up_128(max(r, c))
        benefit, eps0 = _build_benefit(cost, valid, n, eps_min)
        row_to_col = auction_kernel_cuda(
            benefit.reshape(-1, n, n), eps0.reshape(-1),
            valid.flatten(-2).any(dim=-1).reshape(-1),
            eps_scale=eps_scale, eps_min=eps_min, max_iters=max_iters,
        ).reshape(lead + (n,))
    else:
        # one XLA while-loop per problem: what JAX runs under vmap off the TPU
        n = max(r, c)
        benefit, eps0 = _build_benefit(cost, valid, n, eps_min)
        flat_b, flat_e = benefit.reshape(-1, n, n), eps0.reshape(-1)
        row_to_col = torch.stack([
            _auction_while_loop(flat_b[p], flat_e[p], eps_scale, eps_min, max_iters)
            for p in range(flat_b.shape[0])
        ]).reshape(lead + (n,))

    rows = torch.arange(r, device=dev)
    rtc = row_to_col[..., :r]
    safe_cols = torch.clamp(rtc, 0, c - 1).long()
    pair_ok = ((rtc >= 0) & (rtc < c)
               & torch.gather(valid, -1, safe_cols[..., None])[..., 0])
    rtc = torch.where(pair_ok, rtc, -1).to(torch.int32)

    safe = torch.where(rtc >= 0, rtc, 0).long()
    vals = torch.where(rtc >= 0, rows.to(torch.int32), -1)
    col_to_row = torch.full(lead + (c,), -1, dtype=torch.int32, device=dev).scatter_reduce(
        -1, safe, vals, reduce="amax", include_self=True)
    return rtc, col_to_row
