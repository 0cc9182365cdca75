"""Batched 3D math primitives (quaternions, rotations, symmetric covariances).

Torch counterpart of `gaussiansplattingregistration_tpu/ops/math3d.py`.
Everything is a plain function over tensors, batched over a leading N axis
where noted. Quaternions are (w, x, y, z), the 3DGS PLY layout.

Symmetric 3x3 covariances are packed as 6 elements in row-major
upper-triangle order [xx, xy, xz, yy, yz, zz].
"""

from __future__ import annotations

import torch

_EPS = 1e-12
# Matrices per torch.linalg.eigh call. On an H100 (torch 2.11, CUDA 12.8)
# cuSOLVER's batched solver refuses a batch of 200k 3x3 matrices
# (CUSOLVER_STATUS_INVALID_VALUE from its buffer-size query) where 10k pass.
_EIGH_CHUNK = 8192


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """log(x / (1-x)); inverse of the opacity activation."""
    return torch.log(x / (1.0 - x))


def pack_symmetric(m: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] symmetric matrix -> [..., 6] packed [xx, xy, xz, yy, yz, zz]."""
    return torch.stack(
        [m[..., 0, 0], m[..., 0, 1], m[..., 0, 2], m[..., 1, 1], m[..., 1, 2], m[..., 2, 2]],
        dim=-1,
    )


def unpack_symmetric(v: torch.Tensor) -> torch.Tensor:
    """[..., 6] packed -> [..., 3, 3] symmetric matrix."""
    row0 = torch.stack([v[..., 0], v[..., 1], v[..., 2]], dim=-1)
    row1 = torch.stack([v[..., 1], v[..., 3], v[..., 4]], dim=-1)
    row2 = torch.stack([v[..., 2], v[..., 4], v[..., 5]], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def normalize(v: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Safe L2 normalization."""
    n = torch.linalg.norm(v, dim=axis, keepdim=True)
    return v / torch.clamp_min(n, _EPS)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w,x,y,z) quaternion -> [..., 3, 3] rotation matrix
    (normalizes internally)."""
    q = normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation matrix -> [..., 4] (w,x,y,z) unit quaternion.

    Branch-free Shepperd's method: all four candidate quaternions, selected
    by the largest pivot, so 180-degree rotations are handled too.
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    tr = m00 + m11 + m22
    qw = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    qw = torch.sqrt(torch.clamp_min(qw, _EPS)) * 0.5

    w0, x1, y2, z3 = qw[..., 0], qw[..., 1], qw[..., 2], qw[..., 3]
    cand_w = torch.stack([w0, (m21 - m12) / (4 * w0), (m02 - m20) / (4 * w0), (m10 - m01) / (4 * w0)], dim=-1)
    cand_x = torch.stack([(m21 - m12) / (4 * x1), x1, (m01 + m10) / (4 * x1), (m02 + m20) / (4 * x1)], dim=-1)
    cand_y = torch.stack([(m02 - m20) / (4 * y2), (m01 + m10) / (4 * y2), y2, (m12 + m21) / (4 * y2)], dim=-1)
    cand_z = torch.stack([(m10 - m01) / (4 * z3), (m02 + m20) / (4 * z3), (m12 + m21) / (4 * z3), z3], dim=-1)

    case = torch.argmax(qw, dim=-1)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], dim=-2)  # [..., 4(case), 4(comp)]
    idx = case[..., None, None].expand(*case.shape, 1, 4)
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = normalize(q)
    # Canonical sign: w >= 0.
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b for (w,x,y,z) quaternions, broadcastable;
    `R(a ⊗ b) = R(a) R(b)`."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def build_scaling_rotation(s: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """[..., 3] scales (activated) + [..., 4] quats -> L = R diag(s), [..., 3, 3]."""
    return quat_to_rotmat(q) * s[..., None, :]


def covariance_from_scaling_rotation(
    s: torch.Tensor, q: torch.Tensor, scaling_modifier: float = 1.0
) -> torch.Tensor:
    """Activated scales + quats -> packed 6-covariance Σ = L Lᵀ."""
    L = build_scaling_rotation(scaling_modifier * s, q)
    return pack_symmetric(L @ L.transpose(-1, -2))


def axis_angle_to_rotmat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation formula; axis [..., 3], angle scalar [...]."""
    axis = normalize(axis)
    angle = torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    c = torch.cos(angle)
    s = torch.sin(angle)
    omc = 1.0 - c
    return torch.stack(
        [
            torch.stack([c + x * x * omc, x * y * omc - z * s, x * z * omc + y * s], dim=-1),
            torch.stack([y * x * omc + z * s, c + y * y * omc, y * z * omc - x * s], dim=-1),
            torch.stack([z * x * omc - y * s, z * y * omc + x * s, c + z * z * omc], dim=-1),
        ],
        dim=-2,
    )


def transform_covariance(cov6: torch.Tensor, rotmat: torch.Tensor) -> torch.Tensor:
    """Conjugate packed covariances by a rotation: R Σ Rᵀ."""
    full = unpack_symmetric(cov6)
    return pack_symmetric(rotmat @ full @ rotmat.T)


def symmetric_eigh(m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`torch.linalg.eigh` of [..., 3, 3] symmetric matrices (ascending
    eigenvalues), in chunks of `_EIGH_CHUNK` matrices."""
    flat = m.reshape(-1, 3, 3)
    if flat.shape[0] <= _EIGH_CHUNK:
        return torch.linalg.eigh(m)
    vals, vecs = zip(*(torch.linalg.eigh(c) for c in flat.split(_EIGH_CHUNK)))
    return torch.cat(vals).reshape(m.shape[:-1]), torch.cat(vecs).reshape(m.shape)


def decompose_covariance(cov6: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed covariances -> (scales [N,3], quats [N,4]) with Σ = R diag(s²) Rᵀ.

    Eigendecomposition; scales = sqrt(clamped eigenvalues), the quaternion
    from the eigenvector basis with its determinant fixed to +1.
    """
    full = unpack_symmetric(cov6)
    eigvals, eigvecs = symmetric_eigh(full)  # ascending
    scales = torch.sqrt(torch.clamp_min(eigvals, _EPS))
    det = torch.linalg.det(eigvecs)
    flip = torch.ones_like(eigvecs)
    flip[..., :, 2] = torch.sign(det)[..., None]
    quats = rotmat_to_quat(eigvecs * flip)
    return scales, quats


def kabsch_rotation(H: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Optimal proper rotation R maximizing tr(R H), batched [..., 3, 3].

    Horn's quaternion method: the optimal unit quaternion is the dominant
    eigenvector of the symmetric 4x4 N-matrix built from H, extracted by
    shifted power iteration with repeated squaring (2^iters power steps).
    Always yields a proper rotation (det +1).
    """
    S00, S01, S02 = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    S10, S11, S12 = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    S20, S21, S22 = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    row0 = torch.stack([S00 + S11 + S22, S12 - S21, S20 - S02, S01 - S10], dim=-1)
    row1 = torch.stack([S12 - S21, S00 - S11 - S22, S01 + S10, S20 + S02], dim=-1)
    row2 = torch.stack([S20 - S02, S01 + S10, S11 - S00 - S22, S12 + S21], dim=-1)
    row3 = torch.stack([S01 - S10, S20 + S02, S12 + S21, S22 - S00 - S11], dim=-1)
    N = torch.stack([row0, row1, row2, row3], dim=-2)  # [..., 4, 4]

    # Shift by the Frobenius norm: A = N + ||N||_F I is PSD and its dominant
    # eigenvector is the max-eigenvalue eigenvector of N.
    fro = torch.sqrt(torch.sum(N * N, dim=(-2, -1), keepdim=True))
    A = N + torch.eye(4, dtype=N.dtype, device=N.device) * torch.clamp_min(fro, _EPS)
    for _ in range(iters):
        A = A @ A
        A = A / torch.clamp_min(
            torch.sqrt(torch.sum(A * A, dim=(-2, -1), keepdim=True)), _EPS
        )
    q0 = torch.tensor([1.0, 0.1, 0.2, 0.3], dtype=N.dtype, device=N.device)
    q = A @ q0.expand(*N.shape[:-2], 4)[..., None]
    return quat_to_rotmat(normalize(q[..., 0]))


def make_se3(rotmat: torch.Tensor, translation: torch.Tensor) -> torch.Tensor:
    """(3,3) + (3,) -> (4,4) homogeneous transform."""
    top = torch.cat([rotmat, translation[..., :, None]], dim=-1)
    bottom = torch.tensor(
        [0.0, 0.0, 0.0, 1.0], dtype=top.dtype, device=top.device
    ).expand(*top.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)
