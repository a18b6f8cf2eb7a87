"""Vectorized constant-velocity Kalman filter (counterpart of ``tracker/kalman.py``).

State per track: 8-dim [cx, cy, w, h, vcx, vcy, vw, vh], dt = 1 frame.
Measurement: [cx, cy, w, h]. Noise scales with box height.
"""
from __future__ import annotations

from typing import Tuple

import torch

from waymo_2d_tracking_tpu_torch.config import KalmanConfig

STATE_DIM = 8
MEAS_DIM = 4


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _process_noise_diag(h: torch.Tensor, cfg: KalmanConfig) -> torch.Tensor:
    """Q diagonal, (..., 8). Scales with current box height h."""
    pos = (cfg.std_weight_position * h) ** 2
    vel = (cfg.std_weight_velocity * h) ** 2
    return torch.stack([pos, pos, pos, pos, vel, vel, vel, vel], dim=-1)


def _measurement_noise_diag(h: torch.Tensor, cfg: KalmanConfig) -> torch.Tensor:
    """R diagonal, (..., 4)."""
    m = (cfg.std_weight_measurement * h) ** 2
    return torch.stack([m, m, m, m], dim=-1)


def init_track(meas: torch.Tensor, cfg: KalmanConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, cov) from measurements. meas (..., 4) -> (..., 8), (..., 8, 8)."""
    mean = torch.cat([meas, torch.zeros_like(meas)], dim=-1)
    h = torch.clamp(meas[..., 3], min=1.0)
    pos_std = cfg.std_weight_position * h
    vel_std = cfg.std_weight_velocity * h * cfg.init_velocity_std
    diag = torch.stack(
        [pos_std, pos_std, pos_std, pos_std, vel_std, vel_std, vel_std, vel_std],
        dim=-1,
    )
    cov = _eye(STATE_DIM, meas) * (diag[..., None, :] ** 2)
    return mean, cov


def predict(mean: torch.Tensor, cov: torch.Tensor,
            cfg: KalmanConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched predict. F P F^T = [[A+B+C+D, B+D], [C+D, D]] as exact block
    additions (F = [[I, I], [0, I]])."""
    new_mean = torch.cat(
        [mean[..., :MEAS_DIM] + mean[..., MEAS_DIM:], mean[..., MEAS_DIM:]], dim=-1
    )
    a = cov[..., :MEAS_DIM, :MEAS_DIM]
    b = cov[..., :MEAS_DIM, MEAS_DIM:]
    c = cov[..., MEAS_DIM:, :MEAS_DIM]
    d = cov[..., MEAS_DIM:, MEAS_DIM:]
    top = torch.cat([a + b + c + d, b + d], dim=-1)
    bot = torch.cat([c + d, d], dim=-1)
    new_cov = torch.cat([top, bot], dim=-2)
    h = torch.clamp(mean[..., 3], min=1.0)
    q = _process_noise_diag(h, cfg)
    new_cov = new_cov + _eye(STATE_DIM, cov) * q[..., None, :]
    return new_mean, new_cov


def update(
    mean: torch.Tensor,
    cov: torch.Tensor,
    meas: torch.Tensor,
    cfg: KalmanConfig,
    score: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched measurement update: S = P[:4,:4] + R; K = P[:,:4] S^-1;
    x' = x + K y; P' = P - K P[:4, :]. With ``cfg.nsa`` R scales by
    ``max(1 - score, 1e-3)`` (NSA Kalman)."""
    h_meas = torch.clamp(meas[..., 3], min=1.0)
    r = _measurement_noise_diag(h_meas, cfg)
    if cfg.nsa and score is not None:
        r = r * torch.clamp(1.0 - score, min=1e-3)[..., None]

    p_xz = cov[..., :, :MEAS_DIM]                                   # (..., 8, 4)
    s = cov[..., :MEAS_DIM, :MEAS_DIM] + _eye(MEAS_DIM, cov) * r[..., None, :]
    # solve_ex: no error check, so no host sync on the card
    k = torch.linalg.solve_ex(s, p_xz.transpose(-1, -2)).result.transpose(-1, -2)
    innovation = meas - mean[..., :MEAS_DIM]
    new_mean = mean + torch.einsum("...ij,...j->...i", k, innovation)
    new_cov = cov - torch.einsum("...ij,...jk->...ik", k, cov[..., :MEAS_DIM, :])
    return new_mean, new_cov


def gating_distance(
    mean: torch.Tensor, cov: torch.Tensor, meas: torch.Tensor,
    cfg: KalmanConfig = KalmanConfig(),
) -> torch.Tensor:
    """Squared Mahalanobis distance of measurements to track predictions,
    with the projected innovation covariance S = HPH^T + R (R from the
    track's predicted height). mean (..., S, 8), cov (..., S, 8, 8),
    meas (..., D, 4) -> (..., S, D)."""
    h_trk = torch.clamp(mean[..., 3], min=1.0)
    r = _measurement_noise_diag(h_trk, cfg)
    s = cov[..., :MEAS_DIM, :MEAS_DIM] + _eye(MEAS_DIM, cov) * r[..., None, :]
    diff = meas[..., None, :, :] - mean[..., :, None, :MEAS_DIM]    # (..., S, D, 4)
    chol = torch.linalg.cholesky_ex(s + 1e-6 * _eye(MEAS_DIM, s)).L
    z = torch.linalg.solve_ex(chol[..., None, :, :], diff[..., None]).result
    return torch.sum(z.squeeze(-1) ** 2, dim=-1)
