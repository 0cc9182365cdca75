"""Real spherical harmonics: evaluation (3DGS convention) and SE(3) rotation.

Torch counterpart of `gaussiansplattingregistration_tpu/ops/sh.py`. SH
rotation is built from the Ivanic–Ruedenberg recurrence and wired into
`GaussianCloud.transform`.

Basis convention: 3DGS evaluates real SH with the Condon–Shortley-phased real
basis (signs (-1)^m relative to the plain real basis the recurrence produces);
`_sign_conjugate` converts the Wigner matrices accordingly so they act directly
on 3DGS PLY coefficients.
"""

from __future__ import annotations

import math

import torch

SH_C0 = 0.28209479177387814

_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)


def sh2rgb(sh: torch.Tensor) -> torch.Tensor:
    """DC SH coefficient -> RGB in [0,1]-ish (C0*sh + 0.5)."""
    return sh * SH_C0 + 0.5


def rgb2sh(rgb: torch.Tensor) -> torch.Tensor:
    """Inverse of sh2rgb."""
    return (rgb - 0.5) / SH_C0


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def eval_sh(degree: int, coeffs: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Evaluate SH radiance at unit directions, 3DGS convention.

    coeffs: [..., K, 3] with K = (degree+1)^2, DC first; dirs: [..., 3] unit
    view directions. Returns [..., 3] raw radiance (add 0.5 and clamp for
    display).
    """
    result = SH_C0 * coeffs[..., 0, :]
    if degree >= 1:
        x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
        result = (result - _C1 * y * coeffs[..., 1, :] + _C1 * z * coeffs[..., 2, :]
                  - _C1 * x * coeffs[..., 3, :])
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        result = (result
                  + _C2[0] * xy * coeffs[..., 4, :]
                  + _C2[1] * yz * coeffs[..., 5, :]
                  + _C2[2] * (2.0 * zz - xx - yy) * coeffs[..., 6, :]
                  + _C2[3] * xz * coeffs[..., 7, :]
                  + _C2[4] * (xx - yy) * coeffs[..., 8, :])
    if degree >= 3:
        result = (result
                  + _C3[0] * y * (3.0 * xx - yy) * coeffs[..., 9, :]
                  + _C3[1] * xy * z * coeffs[..., 10, :]
                  + _C3[2] * y * (4.0 * zz - xx - yy) * coeffs[..., 11, :]
                  + _C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * coeffs[..., 12, :]
                  + _C3[4] * x * (4.0 * zz - xx - yy) * coeffs[..., 13, :]
                  + _C3[5] * z * (xx - yy) * coeffs[..., 14, :]
                  + _C3[6] * x * (xx - 3.0 * yy) * coeffs[..., 15, :])
    return result


def _wigner_l1(rotmat: torch.Tensor) -> torch.Tensor:
    """Band-1 real Wigner matrix in the (y, z, x) = (m=-1, 0, +1) basis."""
    r = rotmat
    return torch.stack(
        [
            torch.stack([r[1, 1], r[1, 2], r[1, 0]]),
            torch.stack([r[2, 1], r[2, 2], r[2, 0]]),
            torch.stack([r[0, 1], r[0, 2], r[0, 0]]),
        ]
    )


def _ir_next_band(ell: int, r1: torch.Tensor, rp: torch.Tensor) -> torch.Tensor:
    """Ivanic–Ruedenberg recurrence: band-(ell) matrix from band-1 and
    band-(ell-1) (Ivanic & Ruedenberg 1996, with the published errata)."""

    def R1(i: int, j: int):  # i, j in {-1, 0, 1}
        return r1[i + 1, j + 1]

    def Rp(a: int, b: int):  # previous band, indices in [-(ell-1), ell-1]
        return rp[a + ell - 1, b + ell - 1]

    def P(i: int, a: int, b: int):
        if b == ell:
            return R1(i, 1) * Rp(a, ell - 1) - R1(i, -1) * Rp(a, -ell + 1)
        if b == -ell:
            return R1(i, 1) * Rp(a, -ell + 1) + R1(i, -1) * Rp(a, ell - 1)
        return R1(i, 0) * Rp(a, b)

    zero = torch.zeros((), dtype=r1.dtype, device=r1.device)
    rows = []
    for m in range(-ell, ell + 1):
        row = []
        for n in range(-ell, ell + 1):
            if abs(n) < ell:
                denom = (ell + n) * (ell - n)
            else:
                denom = (2 * ell) * (2 * ell - 1)
            u = math.sqrt((ell + m) * (ell - m) / denom)
            v = 0.5 * math.sqrt(
                (1.0 + (1.0 if m == 0 else 0.0))
                * (ell + abs(m) - 1)
                * (ell + abs(m))
                / denom
            ) * (1.0 - 2.0 * (1.0 if m == 0 else 0.0))
            w = -0.5 * math.sqrt(
                (ell - abs(m) - 1) * (ell - abs(m)) / denom
            ) * (1.0 - (1.0 if m == 0 else 0.0))

            entry = zero
            if u != 0.0:
                entry = entry + u * P(0, m, n)
            if v != 0.0:
                if m == 0:
                    V = P(1, 1, n) + P(-1, -1, n)
                elif m > 0:
                    V = P(1, m - 1, n) * math.sqrt(1.0 + (1.0 if m == 1 else 0.0)) \
                        - P(-1, -m + 1, n) * (1.0 - (1.0 if m == 1 else 0.0))
                else:
                    V = P(1, m + 1, n) * (1.0 - (1.0 if m == -1 else 0.0)) \
                        + P(-1, -m - 1, n) * math.sqrt(1.0 + (1.0 if m == -1 else 0.0))
                entry = entry + v * V
            if w != 0.0:
                if m > 0:
                    W = P(1, m + 1, n) + P(-1, -m - 1, n)
                elif m < 0:
                    W = P(1, m - 1, n) - P(-1, -m + 1, n)
                else:
                    W = 0.0
                entry = entry + w * W
            row.append(entry)
        rows.append(torch.stack(row))
    return torch.stack(rows)


def _sign_conjugate(d: torch.Tensor, ell: int) -> torch.Tensor:
    """Convert plain-real-basis Wigner matrix to the CS-phased 3DGS basis."""
    signs = torch.tensor(
        [(-1.0) ** m for m in range(-ell, ell + 1)], dtype=d.dtype, device=d.device
    )
    return d * (signs[:, None] * signs[None, :])


def wigner_d_matrices(max_degree: int, rotmat: torch.Tensor):
    """Real-SH Wigner-D matrices for bands 1..max_degree in the 3DGS basis:
    [2l+1, 2l+1] matrices D_l such that coefficients of a splat rotated by
    `rotmat` transform as c' = D_l @ c."""
    mats = []
    if max_degree >= 1:
        d1 = _wigner_l1(rotmat)
        mats.append(_sign_conjugate(d1, 1))
        prev = d1
        for ell in range(2, max_degree + 1):
            prev = _ir_next_band(ell, d1, prev)
            mats.append(_sign_conjugate(prev, ell))
    return mats


def rotate_sh(features_rest: torch.Tensor, rotmat: torch.Tensor, degree: int) -> torch.Tensor:
    """Rotate higher-order SH coefficients [N, K-1, 3] by a world rotation
    (3, 3) applied to the splats; SH degree 0..3."""
    if degree < 1 or features_rest.shape[-2] == 0:
        return features_rest
    mats = wigner_d_matrices(degree, rotmat.to(features_rest.dtype))
    out = []
    offset = 0
    for ell in range(1, degree + 1):
        width = 2 * ell + 1
        block = features_rest[:, offset:offset + width, :]  # [N, 2l+1, 3]
        out.append(torch.einsum("mn,Nnc->Nmc", mats[ell - 1], block))
        offset += width
    return torch.cat(out, dim=1)
