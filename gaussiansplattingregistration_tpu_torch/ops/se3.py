"""SE(3) Lie group/algebra utilities for pose representation and optimization.

Torch counterpart of `gaussiansplattingregistration_tpu/ops/se3.py`: 4x4
homogeneous matrices plus exp/log maps on se(3), differentiable, with the
same Taylor guards (`_EPS`), since the gradients at xi = 0 depend on them.

Twist convention: xi = (rho, phi) with rho the translational part and phi the
rotational part (axis * angle), both 3-vectors; exp(xi) applies V(phi) @ rho.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def _skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def _eye_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def _bottom_row(top: torch.Tensor) -> torch.Tensor:
    row = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype, device=top.device)
    return row.expand(top.shape[:-2] + (1, 4))


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """so(3) exp map: [..., 3] axis-angle -> [..., 3, 3] rotation (Rodrigues),
    with Taylor-safe coefficients near theta = 0."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp_min(theta2, _EPS * _EPS))
    small = theta2 < _EPS
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp_min(theta2, _EPS * _EPS))
    K = _skew(phi)
    return _eye_like(K) + a[..., None, None] * K + b[..., None, None] * (K @ K)


def so3_log(rotmat: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation -> [..., 3] axis-angle; inverse of so3_exp."""
    tr = rotmat[..., 0, 0] + rotmat[..., 1, 1] + rotmat[..., 2, 2]
    cos_theta = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    w = torch.stack(
        [
            rotmat[..., 2, 1] - rotmat[..., 1, 2],
            rotmat[..., 0, 2] - rotmat[..., 2, 0],
            rotmat[..., 1, 0] - rotmat[..., 0, 1],
        ],
        dim=-1,
    )
    sin_theta = torch.sin(theta)
    small = theta < 1e-4
    scale = torch.where(small, 0.5 + theta * theta / 12.0,
                        theta / torch.clamp_min(2.0 * sin_theta, _EPS))
    # Near theta = pi the vee part vanishes; fall back to diagonal extraction.
    near_pi = theta > math.pi - 1e-3
    diag = torch.stack([rotmat[..., 0, 0], rotmat[..., 1, 1], rotmat[..., 2, 2]], dim=-1)
    axis_sq = torch.clamp_min(
        (diag - cos_theta[..., None]) / torch.clamp_min(1.0 - cos_theta[..., None], _EPS), 0.0)
    axis = torch.sqrt(axis_sq)
    # Resolve signs from off-diagonals (largest-axis reference sign).
    s = torch.sign(w)
    s = torch.where(s == 0, _pi_axis_signs(rotmat, axis), s)
    pi_branch = axis * s * theta[..., None]
    return torch.where(near_pi[..., None], pi_branch, w * scale[..., None])


def _pi_axis_signs(rotmat: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """Sign resolution for the theta ~ pi branch via off-diagonal products."""
    i = torch.argmax(axis, dim=-1)
    sxy = torch.sign(rotmat[..., 0, 1] + rotmat[..., 1, 0])
    sxz = torch.sign(rotmat[..., 0, 2] + rotmat[..., 2, 0])
    syz = torch.sign(rotmat[..., 1, 2] + rotmat[..., 2, 1])
    one = torch.ones_like(sxy)
    sx = torch.where(i == 0, one, torch.where(i == 1, sxy, sxz))
    sy = torch.where(i == 0, sxy, torch.where(i == 1, one, syz))
    sz = torch.where(i == 0, sxz, torch.where(i == 1, syz, one))
    s = torch.stack([sx, sy, sz], dim=-1)
    return torch.where(s == 0, 1.0, s)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exp map: [..., 6] twist (rho, phi) -> [..., 4, 4] transform."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp_min(theta2, _EPS * _EPS))
    small = theta2 < _EPS
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp_min(theta2, _EPS * _EPS))
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / torch.clamp_min(theta2 * theta, _EPS))
    K = _skew(phi)
    V = _eye_like(K) + b[..., None, None] * K + c[..., None, None] * (K @ K)
    t = (V @ rho[..., None])[..., 0]
    top = torch.cat([R, t[..., None]], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] transform -> [..., 6] twist; inverse of se3_exp."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    phi = so3_log(R)
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp_min(theta2, _EPS * _EPS))
    small = theta2 < _EPS
    K = _skew(phi)
    # V^{-1} = I - K/2 + (1/theta^2)(1 - theta sin / (2(1-cos))) K^2
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - theta * torch.sin(theta)
         / torch.clamp_min(2.0 * (1.0 - torch.cos(theta)), _EPS))
        / torch.clamp_min(theta2, _EPS * _EPS),
    )
    Vinv = _eye_like(K) - 0.5 * K + cot_term[..., None, None] * (K @ K)
    rho = (Vinv @ t[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid transform."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    t_inv = -(Rt @ t[..., None])[..., 0]
    top = torch.cat([Rt, t_inv[..., None]], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def apply_se3(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply a (4, 4) transform to [..., 3] points."""
    return points @ T[:3, :3].T + T[:3, 3]
