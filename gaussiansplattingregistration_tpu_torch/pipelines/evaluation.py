"""Loaders shared by photometric registration and evaluation: a 3DGS
`cameras.json` and ground-truth PNGs.

Torch counterpart of the loaders in
`gaussiansplattingregistration_tpu/pipelines/evaluation.py`. Images are
read by the stdlib PNG reader (`utils/png.py`), so no imaging package is
needed.
"""

from __future__ import annotations

import json
from typing import List

import numpy as np

from gaussiansplattingregistration_tpu_torch.models.camera import Camera
from gaussiansplattingregistration_tpu_torch.utils.png import read_png


def load_image(path: str) -> np.ndarray:
    """PNG -> float32 [H, W, 3] in [0, 1]; alpha is dropped and gray
    repeated, as PIL's convert("RGB") does."""
    img = read_png(path)
    if img.ndim == 2:
        img = img[..., None]
    rgb = np.repeat(img[..., :1], 3, axis=2) if img.shape[2] in (1, 2) else img[..., :3]
    return rgb.astype(np.float32) / 255.0


def load_cameras_json(path: str, device=None) -> List[Camera]:
    """Parse a 3DGS-format cameras.json into cameras on `device` (default
    `cuda`)."""
    with open(path) as f:
        entries = json.load(f)
    return [Camera.from_json_entry(e, device=device) for e in entries]
