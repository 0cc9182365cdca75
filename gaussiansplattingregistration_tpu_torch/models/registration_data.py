"""Registration result records (serialized into evaluation logs).

Counterpart of `reference/src/models/registration_data.py:4-60`.

A copy of `gaussiansplattingregistration_tpu/models/registration_data.py`,
which imports no JAX.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class RegistrationResult:
    """What every registration op returns (Open3D result analogue):
    transformation (4x4), fitness = inlier fraction, inlier_rmse."""

    transformation: np.ndarray
    fitness: float
    inlier_rmse: float
    num_iterations: int = 0
    converged: bool = False

    def as_dict(self) -> dict:
        return {
            "transformation": np.asarray(self.transformation).tolist(),
            "fitness": float(self.fitness),
            "inlier_rmse": float(self.inlier_rmse),
            "num_iterations": int(self.num_iterations),
            "converged": bool(self.converged),
        }


@dataclasses.dataclass
class BaseLocalRegistrationData:
    """(`registration_data.py:4-28`)."""

    registration_type: str
    initial_transformation: np.ndarray
    relative_fitness: float
    relative_rmse: float
    result_fitness: float
    result_inlier_rmse: float
    result_transformation: np.ndarray

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["initial_transformation"] = np.asarray(self.initial_transformation).tolist()
        d["result_transformation"] = np.asarray(self.result_transformation).tolist()
        return d


@dataclasses.dataclass
class LocalRegistrationData(BaseLocalRegistrationData):
    """(`registration_data.py:31-42`)."""

    max_correspondence: float = 0.0
    max_iteration: int = 0


@dataclasses.dataclass
class MultiScaleRegistrationData(BaseLocalRegistrationData):
    """(`registration_data.py:45-60`)."""

    voxel_values: Optional[List[float]] = None
    iter_values: Optional[List[int]] = None
    used_sparse_clouds: bool = False
    used_mixture: bool = False
