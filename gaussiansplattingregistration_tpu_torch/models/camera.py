"""Pinhole camera model.

Torch counterpart of `gaussiansplattingregistration_tpu/models/camera.py`.
The view-matrix convention is 3DGS `getWorld2View2`: `R` is the
camera-to-world rotation stored transposed, `T` the world-to-camera
translation; `viewmat = [[Rᵀ, T], [0, 1]]`.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from gaussiansplattingregistration_tpu_torch.ops import math3d
from gaussiansplattingregistration_tpu_torch.utils.device import as_tensor, resolve_device


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def fov_x2fov_y(fov_x: float, aspect_ratio: float) -> float:
    return 2.0 * math.atan(math.tan(fov_x / 2.0) / aspect_ratio)


def focal_lengths_from_spec(width: int, height: int, value: float, fov_type: int):
    """Focal lengths (fx, fy) from a field-of-view input mode: 0 = default
    (0, 0), 1 = field of view (radians, or degrees if > pi), 2 = focal
    length fx."""
    if fov_type == 0:
        return 0.0, 0.0
    if fov_type == 1:
        if value > math.pi:
            value = value * math.pi / 180.0
        return fov2focal(value, width), fov2focal(value, height)
    if fov_type == 2:
        fx = value
        fov_x = focal2fov(fx, width)
        fov_y = fov_x2fov_y(fov_x, width / height)
        return fx, fov2focal(fov_y, height)
    raise ValueError(f"unknown fov_type {fov_type}")


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

    def resized(self, scale: float) -> "Camera":
        """Scale resolution and focal lengths together."""
        return dataclasses.replace(
            self, fx=self.fx * scale, fy=self.fy * scale,
            width=int(round(self.width * scale)), height=int(round(self.height * scale)))

    # -------------------------------------------------- interactive orbit
    # Pure-function orbit controls: each returns a new camera.
    _RIGHT = (1.0, 0.0, 0.0)
    _UP = (0.0, 1.0, 0.0)
    _FORWARD = (0.0, 0.0, 1.0)

    def _axis(self, axis) -> torch.Tensor:
        return torch.tensor(axis, dtype=torch.float32, device=self.rotation.device)

    def _angle(self, a) -> torch.Tensor:
        return torch.tensor(a, dtype=torch.float32, device=self.rotation.device)

    def rotate(self, dx: float, dy: float) -> "Camera":
        """Yaw by dx about the camera's up axis, pitch by -dy about its right
        axis (radians)."""
        up = self.rotation @ self._axis(self._UP)
        right = self.rotation @ self._axis(self._RIGHT)
        yaw = math3d.axis_angle_to_rotmat(up, self._angle(dx))
        pitch = math3d.axis_angle_to_rotmat(right, self._angle(-dy))
        return dataclasses.replace(self, rotation=yaw @ pitch @ self.rotation)

    def translate(self, dx: float, dy: float) -> "Camera":
        """Pan by (dx, dy) pixels at the focal lengths."""
        move = self._axis(self._RIGHT) * (dx / self.fx) + self._axis(self._UP) * (dy / self.fy)
        return dataclasses.replace(self, position=self.position + move)

    def roll(self, dx: float) -> "Camera":
        """Roll about the view axis by 4 pi dx / height radians."""
        radians = 4.0 * math.pi * dx / max(self.height, 1)
        rot = math3d.axis_angle_to_rotmat(self._axis(self._FORWARD), self._angle(radians))
        return dataclasses.replace(self, rotation=self.rotation @ rot)

    def zoom(self, delta: float, aabb_min, aabb_max) -> "Camera":
        """Move along the view axis by delta * 5% of the distance to the
        scene's centre, that distance kept above 2% of the scene's size."""
        aabb_min = as_tensor(aabb_min, self.position.device)
        aabb_max = as_tensor(aabb_max, self.position.device)
        model_size = torch.linalg.norm(aabb_max - aabb_min)
        center = (aabb_min + aabb_max) / 2.0
        length = torch.maximum(0.02 * model_size, torch.linalg.norm(center - self.position))
        dist = delta * 0.05 * length
        return dataclasses.replace(self, position=self.position + dist * self._axis(self._FORWARD))


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
