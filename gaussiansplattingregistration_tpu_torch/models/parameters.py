"""Typed configuration dataclasses — the public config API.

Counterpart of `reference/src/params/*`. Defaults match the reference
exactly (SURVEY.md §5.6): they are the contract users of the reference expect.

A copy of `gaussiansplattingregistration_tpu/models/parameters.py`, which
imports no JAX; the port keeps its own so that it never imports that package.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Sequence


class LocalRegistrationType(enum.Enum):
    """(`reference/src/utils/local_registration_util.py:23-36`)."""

    ICP_POINT_TO_POINT = "Point-to-Point ICP"
    ICP_POINT_TO_PLANE = "Point-to-Plane ICP"
    ICP_COLOR = "Colored ICP"
    ICP_GENERAL = "Generalized ICP"


class KernelLossFunctionType(enum.Enum):
    """Robust kernels (`local_registration_util.py:6-21`)."""

    NONE = "None"
    TUKEY = "Tukey loss"
    CAUCHY = "Cauchy loss"
    GM = "GM loss"
    HUBER = "Huber loss"


class GlobalRegistrationType(enum.Enum):
    RANSAC = "RANSAC"
    FGR = "FGR"


class RANSACEstimationMethod(enum.Enum):
    """(`global_registration_util.py:20-33`; the reference swaps the GICP and
    ColoredICP constructors at `:42-45` — a bug we do not reproduce)."""

    POINT_TO_POINT = "Point-To-Point"
    POINT_TO_PLANE = "Point-To-Plane"
    GENERALIZED_ICP = "For GICP"
    COLORED_ICP = "For CICP"


@dataclasses.dataclass
class LocalRegistrationParams:
    """(`reference/src/params/registration_parameters.py:8-16`)."""

    registration_type: LocalRegistrationType = LocalRegistrationType.ICP_POINT_TO_POINT
    max_correspondence: float = 5.0
    relative_fitness: float = 1e-6
    relative_rmse: float = 1e-6
    max_iteration: int = 30
    rejection_type: KernelLossFunctionType = KernelLossFunctionType.NONE
    k_value: float = 0.0


@dataclasses.dataclass
class FGRRegistrationParams:
    """(`registration_parameters.py:19-28`)."""

    voxel_size: float = 0.05
    division_factor: float = 1.4
    use_absolute_scale: bool = False
    decrease_mu: bool = True
    maximum_correspondence: float = 0.025
    max_iterations: int = 64
    tuple_scale: float = 0.95
    max_tuple_count: int = 1000
    tuple_test: bool = True


@dataclasses.dataclass
class RANSACRegistrationParams:
    """(`registration_parameters.py:32-40`)."""

    voxel_size: float = 0.05
    mutual_filter: bool = False
    max_correspondence: float = 5.0
    estimation_method: RANSACEstimationMethod = RANSACEstimationMethod.POINT_TO_POINT
    ransac_n: int = 3
    checkers: Sequence["CorrespondenceChecker"] = ()
    max_iteration: int = 100000
    confidence: float = 0.999


@dataclasses.dataclass
class CorrespondenceChecker:
    """RANSAC correspondence checkers
    (`reference/src/gui/tabs/global_registration_tab.py:239-247`):
    kind in {"edge_length", "distance", "normal"}."""

    kind: str
    value: float


@dataclasses.dataclass
class GaussianMixtureParams:
    """HEM downsampler params (`reference/src/params/merge_parameters.py:5-10`)."""

    hem_reduction: float = 3.0
    distance_delta: float = 3.0
    color_delta: float = 2.5
    decay_rate: float = 1.0
    cluster_level: int = 3


@dataclasses.dataclass
class PlaneFittingParams:
    """(`reference/src/params/plane_fitting_params.py:5-10`)."""

    plane_count: int = 1
    iterations: int = 100
    distance_threshold: float = 0.01
    normal_threshold: float = 0.9
    min_distance: float = 0.05


@dataclasses.dataclass
class MultiScaleRegistrationParams:
    """Coarse-to-fine schedule
    (`reference/src/gui/tabs/multi_scale_registration_tab.py:12-169`)."""

    use_corresponding_pc: bool = False     # sparse (SfM) bootstrap stage
    sparse_first_path: Optional[str] = None
    sparse_second_path: Optional[str] = None
    registration_type: LocalRegistrationType = LocalRegistrationType.ICP_POINT_TO_POINT
    relative_fitness: float = 1e-6
    relative_rmse: float = 1e-6
    voxel_values: List[float] = dataclasses.field(default_factory=lambda: [0.1, 0.05, 0.01])
    iter_values: List[int] = dataclasses.field(default_factory=lambda: [50, 30, 14])
    rejection_type: KernelLossFunctionType = KernelLossFunctionType.NONE
    k_value: float = 0.0
