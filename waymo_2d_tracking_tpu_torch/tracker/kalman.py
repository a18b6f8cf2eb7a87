"""Vectorized constant-velocity Kalman filter (counterpart of ``tracker/kalman.py``).

State per track: 8-dim [cx, cy, w, h, vcx, vcy, vw, vh], dt = 1 frame.
Measurement: [cx, cy, w, h]. Noise scales with box height.

Every coordinate is filtered on its own: the initial covariance, F, Q and R
act per coordinate, so each 4x4 block of P stays diagonal, and so does the
innovation covariance S. The JAX package solves with S by a general LU
solve; on the CPU (LAPACK, in both packages) that solve of a diagonal
system multiplies by the reciprocals of its pivots, while the card's solver
divides. The port writes the solve out as that reciprocal multiply
(``update``, ``gating_distance``, with the squares summed in order), so the
card gives the CPU's, and the JAX package's, bits.
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
    # S = P[:4, :4] + R is diagonal (module docstring): K = P_xz S^-1 as the
    # reciprocal multiply of the CPU's LU solve
    s_diag = torch.diagonal(cov[..., :MEAS_DIM, :MEAS_DIM], dim1=-2, dim2=-1) + r
    k = p_xz * torch.reciprocal(s_diag)[..., None, :]
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
    s_diag = torch.diagonal(cov[..., :MEAS_DIM, :MEAS_DIM], dim1=-2, dim2=-1) + r
    diff = meas[..., None, :, :] - mean[..., :, None, :MEAS_DIM]    # (..., S, D, 4)
    # the Cholesky factor of the diagonal S + 1e-6 I is its square root,
    # correctly rounded as LAPACK's: torch's vectorized CPU sqrt can be an ulp
    # off, and a float64 square root rounds to the float32 one exactly. The
    # solve with it is the CPU's reciprocal multiply, the squares summed in order
    chol = torch.sqrt((s_diag + 1e-6).double()).float()
    z = diff * torch.reciprocal(chol)[..., :, None, :]
    q = z * z
    return ((q[..., 0] + q[..., 1]) + q[..., 2]) + q[..., 3]
