"""Local registration: the ICP family.

Torch counterpart of `gaussiansplattingregistration_tpu/ops/icp.py` (the
reference's `do_icp_registration`, which delegates to Open3D):

* correspondence search is a blocked brute-force nearest neighbor or, when
  the gate admits it, the 27-cell grid table (`ops/knn.py`), with the JAX
  package's `"auto"` thresholds;
* estimation is a closed-form weighted Kabsch (point-to-point, through
  Horn's quaternion method) or one Gauss-Newton step on se(3) per iteration
  (point-to-plane, colored, generalized), with robust-kernel weights;
* the loop stops as Open3D's does: |Δfitness| < relative_fitness and
  |Δrmse| < relative_rmse after iteration 0, or at max_iteration. The JAX
  `lax.while_loop` becomes a Python loop that reads the test to the host
  once per iteration; with a zero threshold the test can never pass, and
  the loop runs its budget without reading anything back;
* fitness = matched fraction of source points and inlier_rmse = RMSE over
  matches, taken at the returned pose.

Everything runs on the device of the clouds' tensors. The JAX package pads
clouds to shape buckets so that its compiled solver is reused; eager torch
compiles nothing, so `shape_bucket` is accepted and changes nothing.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gaussiansplattingregistration_tpu_torch.models.parameters import (
    KernelLossFunctionType,
    LocalRegistrationParams,
    LocalRegistrationType,
)
from gaussiansplattingregistration_tpu_torch.models.point_cloud import PointCloud
from gaussiansplattingregistration_tpu_torch.models.registration_data import RegistrationResult
from gaussiansplattingregistration_tpu_torch.ops import knn as knn_ops
from gaussiansplattingregistration_tpu_torch.ops import math3d, se3
from gaussiansplattingregistration_tpu_torch.utils import profiling
from gaussiansplattingregistration_tpu_torch.utils.device import as_tensor

LAMBDA_GEOMETRIC = 0.968  # Open3D colored-ICP default
GICP_EPSILON = 1e-3       # Open3D generalized-ICP covariance epsilon


def robust_weight(kind: KernelLossFunctionType, r: torch.Tensor, k: float) -> torch.Tensor:
    """w(r) = psi(r)/r for each Open3D robust loss."""
    if kind is KernelLossFunctionType.NONE or k == 0.0:
        return torch.ones_like(r)
    if kind is KernelLossFunctionType.TUKEY:
        u = r / k
        return torch.where(torch.abs(r) <= k, (1.0 - u * u) ** 2, 0.0)
    if kind is KernelLossFunctionType.CAUCHY:
        u = r / k
        return 1.0 / (1.0 + u * u)
    if kind is KernelLossFunctionType.GM:
        return k / (k + r * r) ** 2
    if kind is KernelLossFunctionType.HUBER:
        return torch.where(torch.abs(r) <= k, 1.0, k / torch.clamp_min(torch.abs(r), 1e-12))
    raise ValueError(f"unknown kernel {kind}")


# --------------------------------------------------------------------------
# Estimation solvers (one update per correspondence round)
# --------------------------------------------------------------------------

def _solve_point_to_point(p, q, w):
    """Weighted Kabsch: best rigid (R, t) aligning p -> q, as a 4x4."""
    wsum = torch.clamp_min(torch.sum(w), 1e-12)
    p_bar = torch.sum(p * w[:, None], dim=0) / wsum
    q_bar = torch.sum(q * w[:, None], dim=0) / wsum
    H = ((p - p_bar) * w[:, None]).T @ (q - q_bar)
    R = math3d.kabsch_rotation(H)
    return math3d.make_se3(R, q_bar - R @ p_bar)


def _solve(A, b):
    """-A^-1 b without a device sync (no singularity check, as jnp's)."""
    return -torch.linalg.solve_ex(A, b)[0]


def _gauss_newton_step(J, r, w, damping=1e-6):
    """Solve the weighted normal equations of sum w (r + J dx)^2; returns
    the se(3) increment as a 4x4. J: [M, 6], r: [M], w: [M]."""
    Jw = J * w[:, None]
    A = Jw.T @ J + damping * torch.eye(6, dtype=J.dtype, device=J.device)
    return se3.se3_exp(_solve(A, Jw.T @ r))


def _solve_point_to_plane(p, q, n, w):
    r = torch.sum((p - q) * n, dim=-1)
    J = torch.cat([n, torch.linalg.cross(p, n, dim=-1)], dim=-1)
    return _gauss_newton_step(J, r, w)


def _solve_colored(p, q, n, c_src, c_tgt, g_tgt, w):
    """Joint geometric + photometric step (Park et al. / Open3D)."""
    r_g = torch.sum((p - q) * n, dim=-1)
    J_g = torch.cat([n, torch.linalg.cross(p, n, dim=-1)], dim=-1)
    # Project p onto the target tangent plane, evaluate linearized intensity.
    d_plane = torch.sum((p - q) * n, dim=-1, keepdim=True)
    p_proj = p - d_plane * n
    r_i = c_tgt + torch.sum(g_tgt * (p_proj - q), dim=-1) - c_src
    # dr_i/dp = (I - n n^T) g
    g_perp = g_tgt - torch.sum(g_tgt * n, dim=-1, keepdim=True) * n
    J_i = torch.cat([g_perp, torch.linalg.cross(p, g_perp, dim=-1)], dim=-1)
    sl = float(np.sqrt(np.float32(LAMBDA_GEOMETRIC)))
    si = float(np.sqrt(np.float32(1.0 - LAMBDA_GEOMETRIC)))
    J = torch.cat([sl * J_g, si * J_i])
    r = torch.cat([sl * r_g, si * r_i])
    return _gauss_newton_step(J, r, torch.cat([w, w]))


def _solve_generalized(p, q, cov_p, cov_q, w):
    """Plane-to-plane (GICP): Mahalanobis residual d^T (Cq + R Cp R^T)^-1 d;
    cov_p is already rotated into the current frame."""
    d = p - q
    eye3 = torch.eye(3, dtype=p.dtype, device=p.device)
    Minv = torch.linalg.inv_ex(cov_q + cov_p + 1e-9 * eye3)[0]
    J = torch.cat([eye3.expand(p.shape[0], 3, 3), -se3._skew(p)], dim=-1)   # [M, 3, 6]
    WM = Minv * w[:, None, None]
    A = torch.einsum("mij,mik,mkl->jl", J, WM, J) \
        + 1e-6 * torch.eye(6, dtype=p.dtype, device=p.device)
    b = torch.einsum("mij,mik,mk->j", J, WM, d)
    return se3.se3_exp(_solve(A, b))


def gicp_regularized_covariances(points: torch.Tensor, covariances: Optional[torch.Tensor],
                                 k: int = 20, epsilon: float = GICP_EPSILON) -> torch.Tensor:
    """(eps, 1, 1)-regularized covariances for GICP, [N, 3, 3]: the
    eigenbasis of the per-point covariances where given (Gaussian splats),
    else of a kNN PCA."""
    if covariances is not None:
        full = math3d.unpack_symmetric(covariances)
    else:
        _, idx = knn_ops.knn(points, points, k=min(k, points.shape[0]))
        neigh = points[idx]
        c = neigh - torch.mean(neigh, dim=1, keepdim=True)
        full = torch.einsum("nki,nkj->nij", c, c) / k
    _, vecs = math3d.symmetric_eigh(full)  # ascending eigenvalues
    vals = torch.tensor([epsilon, 1.0, 1.0], dtype=points.dtype, device=points.device)
    return torch.einsum("nij,j,nkj->nik", vecs, vals, vecs)


def compute_color_gradients(points: torch.Tensor, normals: torch.Tensor,
                            intensities: torch.Tensor, k: int = 30) -> torch.Tensor:
    """Per-point tangent-plane color gradient (Open3D
    `InitializePointCloudForColoredICP` analogue). [N, 3]."""
    k = min(k, points.shape[0])
    _, idx = knn_ops.knn(points, points, k=k)
    rel = points[idx] - points[:, None, :]
    rel_t = rel - torch.sum(rel * normals[:, None, :], dim=-1, keepdim=True) * normals[:, None, :]
    di = intensities[idx] - intensities[:, None]
    # LS for g with soft constraint g . n = 0.
    A = torch.einsum("nki,nkj->nij", rel_t, rel_t) \
        + 10.0 * torch.einsum("ni,nj->nij", normals, normals) \
        + 1e-6 * torch.eye(3, dtype=points.dtype, device=points.device)
    b = torch.einsum("nki,nk->ni", rel_t, di)
    return torch.linalg.solve_ex(A, b[..., None])[0][..., 0]


def _intensity(colors: torch.Tensor) -> torch.Tensor:
    return torch.mean(colors, dim=-1)


def correspondence_plan(source: PointCloud, target: PointCloud, max_correspondence: float,
                        correspondence: str = "auto"):
    """The grid plan `icp` takes for these clouds (`knn.grid_nn_plan`), or
    None for the brute sweep. "auto" picks the grid when Q * N >= 5e8 and
    the candidate width W keeps N / W >= 40 (the JAX package's measured
    crossovers, not retuned for this card)."""
    if correspondence not in ("auto", "brute", "grid"):
        raise ValueError(f"unknown correspondence mode {correspondence!r}")
    want_grid = correspondence == "grid" or (
        correspondence == "auto"
        and source.num_points * target.num_points >= 500_000_000
    )
    if not want_grid:
        return None
    grid = knn_ops.grid_nn_plan(target.points, float(max_correspondence))
    if grid is not None and correspondence == "auto" and 27 * grid[3] * 40 > target.num_points:
        return None
    return grid


def icp(
    source: PointCloud,
    target: PointCloud,
    params: LocalRegistrationParams,
    init_transform=None,
    shape_bucket: bool = False,
    correspondence: str = "auto",
) -> RegistrationResult:
    """Run local ICP registration on the clouds' device.

    `correspondence`: "brute" = blocked [Q, N] min sweep; "grid" = the
    27-cell candidate table, exact under the correspondence gate; "auto"
    = `correspondence_plan`'s choice. `shape_bucket` is accepted for the
    JAX signature and changes nothing (see the module docstring)."""
    with profiling.span("icp.run"):
        del shape_bucket
        dev, dt = target.points.device, target.points.dtype
        T = as_tensor(np.eye(4) if init_transform is None else init_transform, dev)
        grid = correspondence_plan(source, target, params.max_correspondence, correspondence)

        rt = params.registration_type
        tgt_normals = target.normals
        if rt is not LocalRegistrationType.ICP_POINT_TO_POINT and tgt_normals is None:
            from gaussiansplattingregistration_tpu_torch.ops import normals as normals_ops

            tgt_normals = normals_ops.estimate_normals(target.points)
        src_colors, tgt_colors = source.colors, target.colors
        tgt_grads = src_int = tgt_int = None
        if rt is LocalRegistrationType.ICP_COLOR:
            if tgt_colors is None or src_colors is None:
                raise ValueError("colored ICP requires colors on both clouds")
            src_int, tgt_int = _intensity(src_colors), _intensity(tgt_colors)
            tgt_grads = compute_color_gradients(target.points, tgt_normals, tgt_int)
        src_cov = tgt_cov = None
        if rt is LocalRegistrationType.ICP_GENERAL:
            src_cov = gicp_regularized_covariances(source.points, source.covariances)
            tgt_cov = gicp_regularized_covariances(target.points, target.covariances)

        src_points, tgt_points = source.points, target.points
        max_d2 = torch.tensor(params.max_correspondence, dtype=dt, device=dev) ** 2
        n_src = torch.tensor(float(source.num_points), dtype=dt, device=dev)
        if grid is not None:
            g_origin, g_inv, (gnx, gny, gnz), g_occ = grid
            table = knn_ops.build_grid_table(
                tgt_points, torch.ones(target.num_points, dtype=torch.bool, device=dev),
                g_origin, g_inv, gnx, gny, gnz, g_occ)

        def correspondences(T):
            p = src_points @ T[:3, :3].T + T[:3, 3]
            if grid is not None:
                d2, idx = knn_ops.grid_nearest_neighbor(
                    p, table, g_origin, g_inv, gnx, gny, gnz, 27 * g_occ)
            else:
                d2, idx = knn_ops.nearest_neighbor(p, tgt_points)
            mask = d2 <= max_d2
            matched = torch.sum(mask)
            fitness = matched.to(dt) / n_src
            rmse = torch.sqrt(torch.sum(torch.where(mask, d2, 0.0))
                              / torch.clamp_min(matched, 1).to(dt))
            return p, idx, mask, fitness, rmse

        def step(T):
            p, idx, mask, fitness, rmse = correspondences(T)
            q = tgt_points[idx]
            wm = mask.to(dt)
            if rt is LocalRegistrationType.ICP_POINT_TO_POINT:
                # Open3D never applies robust kernels to point-to-point.
                delta = _solve_point_to_point(p, q, wm)
            else:
                n = tgt_normals[idx]
                w = wm * robust_weight(params.rejection_type, torch.sum((p - q) * n, dim=-1),
                                       float(params.k_value))
                if rt is LocalRegistrationType.ICP_POINT_TO_PLANE:
                    delta = _solve_point_to_plane(p, q, n, w)
                elif rt is LocalRegistrationType.ICP_COLOR:
                    delta = _solve_colored(p, q, n, src_int, tgt_int[idx], tgt_grads[idx], w)
                elif rt is LocalRegistrationType.ICP_GENERAL:
                    R = T[:3, :3]
                    cov_p = torch.einsum("ij,njk,lk->nil", R, src_cov, R)
                    delta = _solve_generalized(p, q, cov_p, tgt_cov[idx], w)
                else:
                    raise ValueError(rt)
            return delta @ T, fitness, rmse

        rel_f = torch.tensor(params.relative_fitness, dtype=dt, device=dev)
        rel_r = torch.tensor(params.relative_rmse, dtype=dt, device=dev)
        # |Δ| < threshold can only hold for a positive threshold.
        can_converge = params.relative_fitness > 0 and params.relative_rmse > 0
        prev_f = prev_r = None
        iters, converged = 0, False
        while iters < params.max_iteration and not converged:
            with profiling.span("icp.iteration"):
                T, f_new, r_new = step(T)
                if can_converge and iters > 0:
                    with profiling.span("icp.converge"):
                        converged = bool((torch.abs(f_new - prev_f) < rel_f)
                                         & (torch.abs(r_new - prev_r) < rel_r))
            prev_f, prev_r = f_new, r_new
            iters += 1
        profiling.count("icp.iterations", iters)
        # Final metrics at the returned pose (Open3D reports post-update values).
        _, _, _, fitness, rmse = correspondences(T)
        return RegistrationResult(
            transformation=T.detach().cpu().numpy().astype(np.float64),
            fitness=float(fitness),
            inlier_rmse=float(rmse),
            num_iterations=iters,
            converged=converged,
        )
