"""Coarse-to-fine multiscale registration.

Torch counterpart of `gaussiansplattingregistration_tpu/pipelines/multiscale.py`:

* optional stage-0 bootstrap on sparse (SfM) clouds;
* voxel strategy: per scale, voxel-downsample at the radius, estimate
  normals (2x radius, nn=30), ICP with correspondence distance = radius and
  the scale's iteration budget;
* mixture strategy: precomputed HEM levels, coarsest -> finest, with
  per-level correspondence distances and iteration counts;
* each scale's result seeds the next.

Everything runs on the device of the clouds' tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from gaussiansplattingregistration_tpu_torch.models.parameters import (
    LocalRegistrationParams,
    MultiScaleRegistrationParams,
)
from gaussiansplattingregistration_tpu_torch.models.point_cloud import PointCloud
from gaussiansplattingregistration_tpu_torch.models.registration_data import RegistrationResult
from gaussiansplattingregistration_tpu_torch.ops import icp as icp_ops
from gaussiansplattingregistration_tpu_torch.ops import normals as normals_ops
from gaussiansplattingregistration_tpu_torch.ops.voxel import voxel_downsample
from gaussiansplattingregistration_tpu_torch.utils import profiling


def _validate(params: MultiScaleRegistrationParams) -> None:
    """List-length checks of the reference's multiscale registrators."""
    if len(params.voxel_values) != len(params.iter_values):
        raise ValueError(
            "voxel_values and iter_values must have equal length "
            f"({len(params.voxel_values)} vs {len(params.iter_values)})"
        )
    if not params.voxel_values:
        raise ValueError("multiscale registration needs at least one scale")


def _scale_params(params: MultiScaleRegistrationParams, corr: float, iters: int):
    return LocalRegistrationParams(
        registration_type=params.registration_type,
        max_correspondence=corr,
        relative_fitness=params.relative_fitness,
        relative_rmse=params.relative_rmse,
        max_iteration=iters,
        rejection_type=params.rejection_type,
        k_value=params.k_value,
    )


def multiscale_voxel_registration(
    source: PointCloud,
    target: PointCloud,
    params: MultiScaleRegistrationParams,
    init_transform=None,
    sparse_source: Optional[PointCloud] = None,
    sparse_target: Optional[PointCloud] = None,
    correspondence: str = "auto",
) -> RegistrationResult:
    """Voxel-pyramid coarse-to-fine ICP; `correspondence` is forwarded to
    `ops.icp.icp` ("auto"/"brute"/"grid")."""
    with profiling.span("multiscale.register"):
        _validate(params)
        current = np.eye(4) if init_transform is None else np.asarray(init_transform)

        if params.use_corresponding_pc and sparse_source is not None and sparse_target is not None:
            boot = icp_ops.icp(
                sparse_source, sparse_target,
                _scale_params(params, max(params.voxel_values), max(params.iter_values)),
                init_transform=current, shape_bucket=True,
            )
            current = boot.transformation

        result = None
        for radius, iters in zip(params.voxel_values, params.iter_values):
            with profiling.span("multiscale.scale"):
                src_down = voxel_downsample(source, radius)
                tgt_down = voxel_downsample(target, radius)
                src_down = dataclasses.replace(src_down, normals=normals_ops.estimate_normals(
                    src_down.points, k=30, radius=radius * 2))
                tgt_down = dataclasses.replace(tgt_down, normals=normals_ops.estimate_normals(
                    tgt_down.points, k=30, radius=radius * 2))
                result = icp_ops.icp(
                    src_down, tgt_down, _scale_params(params, radius, iters),
                    init_transform=current, shape_bucket=True, correspondence=correspondence,
                )
            current = result.transformation
        return dataclasses.replace(result, transformation=current)


def multiscale_mixture_registration(
    source_levels: Sequence[PointCloud],
    target_levels: Sequence[PointCloud],
    params: MultiScaleRegistrationParams,
    init_transform=None,
    correspondence: str = "auto",
) -> RegistrationResult:
    """HEM-level coarse-to-fine ICP. The levels are ordered finest ->
    coarsest (level 0 = the original cloud); the loop walks them
    coarsest-first, `levels[-(i+1)]`, with per-level correspondence
    distances (voxel_values) and iteration counts."""
    with profiling.span("multiscale.register"):
        _validate(params)
        n_scales = len(params.voxel_values)
        if len(source_levels) < n_scales or len(target_levels) < n_scales:
            raise ValueError(
                f"need at least {n_scales} mixture levels, got "
                f"{len(source_levels)}/{len(target_levels)}"
            )
        current = np.eye(4) if init_transform is None else np.asarray(init_transform)

        result = None
        for i, (corr, iters) in enumerate(zip(params.voxel_values, params.iter_values)):
            with profiling.span("multiscale.scale"):
                src = source_levels[-(i + 1)]
                tgt = target_levels[-(i + 1)]
                if src.normals is None:
                    src = normals_ops.with_estimated_normals(src)
                if tgt.normals is None:
                    tgt = normals_ops.with_estimated_normals(tgt)
                result = icp_ops.icp(
                    src, tgt, _scale_params(params, corr, iters),
                    init_transform=current, shape_bucket=True, correspondence=correspondence,
                )
            current = result.transformation
        return dataclasses.replace(result, transformation=current)
