"""Pinhole camera model.

Torch counterpart of `gaussiansplattingregistration_tpu/models/camera.py`.
The view-matrix convention is 3DGS `getWorld2View2`: `R` is the
camera-to-world rotation stored transposed, `T` the world-to-camera
translation; `viewmat = [[Rᵀ, T], [0, 1]]`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gaussiansplattingregistration_tpu_torch.ops import math3d
from gaussiansplattingregistration_tpu_torch.utils.device import as_tensor, resolve_device


@dataclasses.dataclass(frozen=True)
class Camera:
    """Immutable pinhole camera. `rotation` is camera-to-world (3DGS `R`),
    `position` the world-to-camera translation (3DGS `T`)."""

    rotation: torch.Tensor  # (3, 3)
    position: torch.Tensor  # (3,)
    fx: torch.Tensor        # scalar
    fy: torch.Tensor        # scalar
    width: int = 0
    height: int = 0
    image_name: str = ""

    # ------------------------------------------------------------- factory
    @classmethod
    def create(cls, R, T, fx, fy, width, height, image_name="", device=None) -> "Camera":
        """Camera on `device` (default `cuda`)."""
        dev = resolve_device(device)
        return cls(
            rotation=as_tensor(R, dev),
            position=as_tensor(T, dev),
            fx=as_tensor(fx, dev),
            fy=as_tensor(fy, dev),
            width=int(width),
            height=int(height),
            image_name=image_name,
        )

    @classmethod
    def from_numpy(cls, R, T, fx, fy, w, h, device=None) -> "Camera":
        """Camera from the numpy arrays and numbers a JAX `Camera` holds
        (`np.asarray(cam.rotation)`, ...)."""
        return cls.create(np.asarray(R), np.asarray(T), float(fx), float(fy),
                          w, h, device=device)

    @classmethod
    def from_json_entry(cls, entry: dict, device=None) -> "Camera":
        """Build from one 3DGS `cameras.json` record."""
        rot = np.asarray(entry["rotation"], dtype=np.float64)
        pos = np.asarray(entry["position"], dtype=np.float64)
        w2c = np.eye(4)
        w2c[:3, :3] = rot
        w2c[:3, 3] = pos
        rt = np.linalg.inv(w2c)
        R = rt[:3, :3].T
        T = rt[:3, 3]
        return cls.create(
            R, T, entry["fx"], entry["fy"], entry["width"], entry["height"],
            image_name=entry.get("img_name", ""), device=device,
        )

    # ---------------------------------------------------------- projection
    @property
    def intrinsics(self) -> torch.Tensor:
        """(3, 3) K matrix with the principal point at the image center."""
        K = torch.zeros((3, 3), dtype=torch.float32, device=self.fx.device)
        K[0, 0] = self.fx
        K[1, 1] = self.fy
        K[0, 2] = self.width / 2.0
        K[1, 2] = self.height / 2.0
        K[2, 2] = 1.0
        return K

    @property
    def viewmat(self) -> torch.Tensor:
        """(4, 4) world-to-camera matrix (`getWorld2View2` semantics)."""
        return math3d.make_se3(self.rotation.T, self.position)

    @property
    def cam_center(self) -> torch.Tensor:
        """Camera center in world coordinates."""
        return -(self.rotation @ self.position)

    def with_viewmat(self, viewmat) -> "Camera":
        """Set pose from a 4x4 view matrix."""
        V = as_tensor(viewmat, self.rotation.device)
        return dataclasses.replace(self, rotation=V[:3, :3].T, position=V[:3, 3])


def look_at(eye, lookat, up, zoom: float = 1.0, forward: str = "-z",
            device=None) -> torch.Tensor:
    """Build a 4x4 view matrix on `device` (default `cuda`).

    forward="-z" is the OpenGL convention (the camera looks along its
    NEGATIVE z axis). The rasterizer uses the +z-forward COLMAP/3DGS
    convention and culls z <= near, so cameras built for it need
    forward="+z"."""
    dev = resolve_device(device)
    eye, lookat, up = (as_tensor(a, dev) for a in (eye, lookat, up))
    front = math3d.normalize(lookat - eye)
    eye = lookat - front * zoom
    if forward == "+z":
        z_axis = front
    elif forward == "-z":
        z_axis = -front
    else:
        raise ValueError(f"forward must be '+z' or '-z', got {forward!r}")
    x_axis = math3d.normalize(torch.linalg.cross(up, z_axis))
    y_axis = torch.linalg.cross(z_axis, x_axis)
    R = torch.stack([x_axis, y_axis, z_axis])
    t = -R @ eye
    return math3d.make_se3(R, t)
