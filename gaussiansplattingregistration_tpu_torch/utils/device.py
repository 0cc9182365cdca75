"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`device`, or `cuda` when None. Raises when CUDA is asked for and absent:
    the port never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def as_tensor(a, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """`a` as a `dtype` tensor on `device`. Non-tensor input is copied first:
    numpy buffers read from PLY or npz files are read-only."""
    if not torch.is_tensor(a):
        a = np.array(a)
    return torch.as_tensor(a, dtype=dtype, device=device)
