"""Workspace: the session-state container.

Torch counterpart of `gaussiansplattingregistration_tpu/models/workspace.py`:
per-level cloud lists for both inputs, plane fits, the last registration
record, and the central 4x4 transformation that every registration writes
and every merger or renderer reads. Change notification is a plain callback
list. Clouds stay on the device they were loaded on.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np

from gaussiansplattingregistration_tpu_torch.models.gaussian_cloud import GaussianCloud
from gaussiansplattingregistration_tpu_torch.models.point_cloud import PointCloud
from gaussiansplattingregistration_tpu_torch.models.registration_data import RegistrationResult


@dataclasses.dataclass
class Workspace:
    """Mutable session state for interactive / scripted use."""

    # Per-HEM-level lists; index 0 = the loaded clouds.
    gaussian_list_first: List[GaussianCloud] = dataclasses.field(default_factory=list)
    gaussian_list_second: List[GaussianCloud] = dataclasses.field(default_factory=list)
    point_list_first: List[PointCloud] = dataclasses.field(default_factory=list)
    point_list_second: List[PointCloud] = dataclasses.field(default_factory=list)
    current_index: int = 0                       # HEM level selector

    # Plane fitting results, per input cloud.
    plane_coefficients_first: List[np.ndarray] = dataclasses.field(default_factory=list)
    plane_coefficients_second: List[np.ndarray] = dataclasses.field(default_factory=list)
    plane_indices_first: List[np.ndarray] = dataclasses.field(default_factory=list)
    plane_indices_second: List[np.ndarray] = dataclasses.field(default_factory=list)

    last_registration: Optional[RegistrationResult] = None

    _transformation: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(4))
    _listeners: List[Callable[[np.ndarray], None]] = dataclasses.field(default_factory=list)

    # ------------------------------------------------------- transformation
    @property
    def transformation(self) -> np.ndarray:
        return self._transformation

    @transformation.setter
    def transformation(self, value) -> None:
        """Set + notify only on an actual change."""
        value = np.asarray(value, np.float64)
        if np.array_equal(value, self._transformation):
            return
        self._transformation = value
        for fn in self._listeners:
            fn(value)

    def on_transformation_changed(self, fn: Callable[[np.ndarray], None]) -> None:
        self._listeners.append(fn)

    # ------------------------------------------------------------- clouds
    def load_pair(self, first: GaussianCloud, second: GaussianCloud) -> None:
        """Reset the level lists to the loaded pair."""
        from gaussiansplattingregistration_tpu_torch.utils import io as gio

        if first.sh_degree != second.sh_degree:
            raise ValueError(f"SH degree mismatch: {first.sh_degree} vs {second.sh_degree}")
        self.gaussian_list_first = [first]
        self.gaussian_list_second = [second]
        self.point_list_first = [gio.gaussian_to_point_cloud(first)]
        self.point_list_second = [gio.gaussian_to_point_cloud(second)]
        self.current_index = 0

    def _append_levels(self, clouds_first, clouds_second) -> None:
        from gaussiansplattingregistration_tpu_torch.utils import io as gio

        for lvl in clouds_first:
            self.gaussian_list_first.append(lvl)
            self.point_list_first.append(gio.gaussian_to_point_cloud(lvl))
        for lvl in clouds_second:
            self.gaussian_list_second.append(lvl)
            self.point_list_second.append(gio.gaussian_to_point_cloud(lvl))

    def append_mixture_levels(self, levels_first, levels_second, sh_degree) -> None:
        """Append HEM levels 1..N, on the devices of the loaded clouds."""
        from gaussiansplattingregistration_tpu_torch.ops import hem

        self._append_levels(
            hem.mixture_levels_to_clouds(levels_first, sh_degree,
                                         device=self.gaussian_list_first[0].device),
            hem.mixture_levels_to_clouds(levels_second, sh_degree,
                                         device=self.gaussian_list_second[0].device))

    @property
    def current_pair(self):
        i = self.current_index
        return self.point_list_first[i], self.point_list_second[i]

    @property
    def inlier_pair(self):
        """The level-0 pair restricted to the concatenated plane-inlier
        subsets: what inlier registration registers on."""
        from gaussiansplattingregistration_tpu_torch.pipelines.planes import select_plane_inliers

        if not self.plane_indices_first or not self.plane_indices_second:
            raise ValueError("no fitted planes stored — run plane fitting on both clouds "
                             "before inlier registration")
        return (select_plane_inliers(self.point_list_first[0], self.plane_indices_first),
                select_plane_inliers(self.point_list_second[0], self.plane_indices_second))

    def clear_planes(self) -> None:
        self.plane_coefficients_first = []
        self.plane_coefficients_second = []
        self.plane_indices_first = []
        self.plane_indices_second = []

    def apply_plane_merge(self, params, seed: int = 0) -> None:
        """Per-plane HEM merge of both loaded clouds (seeds `seed` and
        `seed + 1`): the merged levels replace any existing HEM levels and
        the plane state is cleared."""
        from gaussiansplattingregistration_tpu_torch.pipelines.planes import merge_plane_inliers

        if not self.gaussian_list_first or not self.gaussian_list_second:
            raise ValueError("load two Gaussian clouds before plane merging")
        if not self.plane_indices_first or not self.plane_indices_second:
            raise ValueError("no fitted planes stored — run plane fitting on both clouds first")
        levels_first = merge_plane_inliers(self.gaussian_list_first[0], self.plane_indices_first,
                                           params, seed=seed)
        levels_second = merge_plane_inliers(self.gaussian_list_second[0],
                                            self.plane_indices_second, params, seed=seed + 1)
        self.gaussian_list_first = self.gaussian_list_first[:1]
        self.gaussian_list_second = self.gaussian_list_second[:1]
        self.point_list_first = self.point_list_first[:1]
        self.point_list_second = self.point_list_second[:1]
        self._append_levels(levels_first, levels_second)
        self.clear_planes()
