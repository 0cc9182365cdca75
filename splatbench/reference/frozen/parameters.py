"""HEM's parameter type, copied from the port's typed configuration
dataclasses (the reference's own `merge_parameters.py`)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class GaussianMixtureParams:
    """HEM downsampler params (`reference/src/params/merge_parameters.py:5-10`)."""

    hem_reduction: float = 3.0
    distance_delta: float = 3.0
    color_delta: float = 2.5
    decay_rate: float = 1.0
    cluster_level: int = 3
