"""Merging and saving aligned clouds.

Torch counterpart of `gaussiansplattingregistration_tpu/pipelines/merge.py`:
`merge_and_save` works on in-memory clouds, `merge_from_paths` loads both
Gaussian PLYs first (for a registration that ran on other, e.g.
downsampled, clouds than the ones to merge).
"""

from __future__ import annotations

from gaussiansplattingregistration_tpu_torch.models.gaussian_cloud import GaussianCloud
from gaussiansplattingregistration_tpu_torch.utils import io as gio


def merge_and_save(
    first: GaussianCloud,
    second: GaussianCloud,
    transformation,
    output_path: str,
) -> GaussianCloud:
    """Transform `first`, concatenate with `second`, write the 3DGS PLY.
    Raises ValueError on an SH-degree mismatch."""
    merged = first.merge(second, transformation)
    gio.save_gaussian_cloud(merged, output_path)
    return merged


def merge_from_paths(
    first_path: str,
    second_path: str,
    transformation,
    output_path: str,
    device=None,
) -> GaussianCloud:
    """Load both PLYs (must be Gaussian clouds) onto `device` (default
    `cuda`), merge under the transform, save."""
    first = gio.load_gaussian_cloud(first_path, device=device)
    second = gio.load_gaussian_cloud(second_path, device=device)
    return merge_and_save(first, second, transformation, output_path)
