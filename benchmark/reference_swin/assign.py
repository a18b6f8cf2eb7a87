"""Eps-scaled auction assignment in NumPy, float32.

``benefit`` builds the padded square maximisation problem (the program's
documented construction: padding worse than any chain of valid pairs, a
row-rotated nudge below eps_min / 4 that breaks exact ties, eps0 half the
benefit range). Two schedules solve it; an eps-optimal auction's answer
depends on its schedule, and the program documents which one each device
runs:

- ``solve_jacobi``: the card's schedule (a Jacobi auction, every phase
  restarting from no owners with the prices kept; each round every
  unassigned row bids for its best column at ``(b_best - v2) + e``; a column
  takes the highest bid, ties to the lowest row);
- ``solve_sequential``: the CPU's schedule (phases while eps > eps_min, then
  a polish phase at eps_min; ownership rebuilt each round as the highest
  row owning a column).
"""
from __future__ import annotations

import numpy as np
import torch

BIG = np.float32(1e30)


def benefit(cost: torch.Tensor, valid: torch.Tensor, n_out: int, eps_min: float):
    """cost / valid (..., R, C) -> (benefit (..., n, n) float32, eps0 (...,))
    on the cost's device."""
    r, c = cost.shape[-2:]
    lead = cost.shape[:-2]
    dev = cost.device
    costf = cost.float()
    masked = torch.where(valid, costf, 0.0)
    c_max = torch.clamp(masked.amax(dim=(-2, -1)), min=0.0)
    c_min = torch.clamp(masked.amin(dim=(-2, -1)), max=0.0)
    pad = -((c_max - c_min) * float(n_out) + 1.0) + c_min
    ben = torch.zeros(lead + (n_out, n_out), dtype=torch.float32, device=dev)
    ben[..., :r, :c] = torch.where(valid, -costf, 0.0)
    mask = torch.zeros(lead + (n_out, n_out), dtype=torch.bool, device=dev)
    mask[..., :r, :c] = valid
    ben = torch.where(mask, ben, pad[..., None, None])
    idx = torch.arange(n_out, dtype=torch.float32, device=dev)
    rot = torch.remainder(idx[None, :] - idx[:, None], float(n_out))
    tiny = float(np.float32(eps_min) / np.float32(4.0 * n_out))
    ben = ben - rot * tiny
    eps0 = torch.clamp(((c_max - pad) - c_min) * 0.5, min=eps_min)
    return ben, eps0


def solve_jacobi(b: np.ndarray, eps0: np.float32, eps_scale: float, eps_min: float,
                 max_iters: int) -> np.ndarray:
    """One problem, benefit (n, n) float32 -> row_to_col (n,) int32. Most
    rounds have a single bidder; they run on scalars."""
    n = b.shape[0]
    e_min = np.float32(eps_min)
    e_stop = np.float32(eps_min * 1.000001)
    scale = np.float32(eps_scale)
    prices = np.zeros(n, np.float32)
    rtc = np.full(n, -1, np.int64)
    eps = np.float32(eps0)
    while eps > 0:
        e = max(eps, e_min)
        rtc[:] = -1
        owner = np.full(n, -1, np.int64)
        free = list(range(n))                                   # unassigned rows
        it = 0
        while free and it < max_iters:
            if len(free) == 1:
                r = free[0]
                v = b[r] - prices
                j = int(v.argmax())                             # lowest among equal maxima
                v[j] = -BIG
                prices[j] = (b[r, j] - v.max()) + e
                old = int(owner[j])
                owner[j], rtc[r] = r, j
                if old >= 0:
                    rtc[old] = -1
                free = [old] if old >= 0 else []
            else:
                rows = np.array(free, dtype=np.int64)
                v = b[rows] - prices                            # (k, n) float32
                j = v.argmax(axis=1)
                k = np.arange(rows.size)
                b_best = b[rows, j]
                v[k, j] = -BIG
                bid = (b_best - v.max(axis=1)) + e
                order = np.lexsort((rows, -bid, j))             # by column, highest bid, lowest row
                js = j[order]
                first = np.empty(order.size, bool)
                first[0] = True
                first[1:] = js[1:] != js[:-1]
                win = order[first]
                wc, wr = j[win], rows[win]
                prices[wc] = bid[win]
                old = owner[wc]
                old = old[old >= 0]
                rtc[old] = -1
                owner[wc] = wr
                rtc[wr] = wc
                won = np.zeros(n, bool)
                won[wr] = True
                free = [int(x) for x in rows if not won[x]] + [int(x) for x in old]
            it += 1
        eps = np.float32(0.0) if e <= e_stop else np.float32(eps * scale)
    return rtc.astype(np.int32)


def _phase(b, prices, eps, max_iters):
    n = b.shape[0]
    idx = np.arange(n)
    neg = np.float32(-1e30)
    rtc = np.full(n, -1, np.int32)
    owner = np.full(n, -1, np.int64)
    p = prices
    it = 0
    while it < max_iters and (rtc < 0).any():
        un = rtc < 0
        v = b - p[None, :]
        jb = v.argmax(axis=1)
        v1 = v[idx, jb]
        v[idx, jb] = neg
        bid = p[jb] + (v1 - v.max(axis=1)) + eps
        cand = np.where(un, bid, neg)
        best = np.full(n, neg, np.float32)
        np.maximum.at(best, jb, cand)
        win_rows = np.where(cand == best[jb], idx, n)
        col_win = np.full(n, n, np.int64)
        np.minimum.at(col_win, jb, win_rows)
        has = best > neg * np.float32(0.5)
        p = np.where(has, best, p)
        owner = np.where(has, col_win, owner)
        rtc = np.full(n, -1, np.int32)
        owned = owner >= 0
        np.maximum.at(rtc, owner[owned], idx[owned].astype(np.int32))
        it += 1
    return rtc, p


def solve_sequential(b: np.ndarray, eps0: np.float32, eps_scale: float, eps_min: float,
                     max_iters: int) -> np.ndarray:
    prices = np.zeros(b.shape[0], np.float32)
    eps = np.float32(eps0)
    e_min = np.float32(eps_min)
    while eps > e_min:
        _, prices = _phase(b, prices, eps, max_iters)
        eps = max(eps * np.float32(eps_scale), e_min * np.float32(0.5))
    return _phase(b, prices, e_min, max_iters)[0]


def auction(cost, row_mask, col_mask, forbid, eps_scale, eps_min, max_iters, problems=None):
    """Min-cost assignment of (..., R, C); (row_to_col, col_to_row), -1 for
    unmatched, pairs through padding or forbidden entries unmatched. On a
    CUDA tensor the card's schedule at the card's padded size, on a CPU
    tensor the CPU's. ``problems``: the flat indices of the problems to solve
    (None: all); the others are left unmatched."""
    r, c = cost.shape[-2:]
    lead = cost.shape[:-2]
    dev = cost.device
    valid = row_mask[..., :, None] & col_mask[..., None, :] & ~forbid
    if dev.type == "cuda":
        m = max(r, c)
        n = 64 if m <= 64 else ((max(m, 128) + 127) // 128) * 128
        solve = solve_jacobi
    else:
        n, solve = max(r, c), solve_sequential
    ben, eps0 = benefit(cost, valid, n, eps_min)
    feasible = valid.flatten(-2).any(-1).reshape(-1).cpu().numpy()
    bens = ben.reshape(-1, n, n).cpu().numpy()
    eps0s = eps0.reshape(-1).cpu().numpy()
    out = np.full((bens.shape[0], n), -1, np.int32)
    for p in range(bens.shape[0]) if problems is None else problems:
        if feasible[p] and eps0s[p] > 0:
            out[p] = solve(bens[p], eps0s[p], eps_scale, eps_min, max_iters)
    rtc = torch.from_numpy(out).to(dev).reshape(lead + (n,))[..., :r]
    safe = torch.clamp(rtc, 0, c - 1).long()
    ok = (rtc >= 0) & (rtc < c) & torch.gather(valid, -1, safe[..., None])[..., 0]
    rtc = torch.where(ok, rtc, -1).to(torch.int32)
    rows = torch.arange(r, device=dev)
    ctr = torch.full(lead + (c,), -1, dtype=torch.int32, device=dev).scatter_reduce(
        -1, torch.where(rtc >= 0, rtc, 0).long(), torch.where(rtc >= 0, rows.to(torch.int32), -1),
        reduce="amax", include_self=True)
    return rtc, ctr
