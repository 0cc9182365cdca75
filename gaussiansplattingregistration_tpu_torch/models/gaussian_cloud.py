"""GaussianCloud: the splat cloud, the system's state.

Torch counterpart of `gaussiansplattingregistration_tpu/models/gaussian_cloud.py`:
an immutable dataclass of raw (pre-activation) parameter tensors whose
methods return new clouds. The system has no weights; the cloud is what
carries state between the JAX package and this one (`from_numpy_dict` takes
the JAX cloud's `to_numpy_dict()`).

Raw storage matches the 3DGS PLY layout: xyz, features_dc [N,1,3],
features_rest [N,K-1,3], opacity logits [N,1], log-scales [N,3],
unnormalized quaternions (w,x,y,z) [N,4], plus the cached packed covariance.
"""

from __future__ import annotations

import dataclasses
import math
import numpy as np
import torch

from gaussiansplattingregistration_tpu_torch.ops import math3d, sh as sh_ops
from gaussiansplattingregistration_tpu_torch.utils.device import as_tensor, resolve_device


@dataclasses.dataclass(frozen=True)
class GaussianCloud:
    """A cloud of N 3D Gaussians with SH radiance. Activations: exp for
    scale, sigmoid for opacity, L2-normalize for rotation."""

    xyz: torch.Tensor               # [N, 3]
    features_dc: torch.Tensor       # [N, 1, 3]
    features_rest: torch.Tensor     # [N, K-1, 3] (K = (sh_degree+1)^2)
    opacity: torch.Tensor           # [N, 1] logits
    scaling: torch.Tensor           # [N, 3] log-scale
    rotation: torch.Tensor          # [N, 4] unnormalized quaternion (w, x, y, z)
    covariance: torch.Tensor        # [N, 6] packed symmetric, cached activation
    sh_degree: int = 0

    # ---------------------------------------------------------------- basic
    def __len__(self) -> int:
        return int(self.xyz.shape[0])

    @property
    def num_points(self) -> int:
        return int(self.xyz.shape[0])

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    # ---------------------------------------------------------- activations
    @property
    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    @property
    def get_rotation(self) -> torch.Tensor:
        return math3d.normalize(self.rotation)

    @property
    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity)

    @property
    def get_features(self) -> torch.Tensor:
        """[N, K, 3] full SH stack, DC first."""
        return torch.cat([self.features_dc, self.features_rest], dim=1)

    @property
    def get_colors(self) -> torch.Tensor:
        """[N, 3] DC coefficients."""
        return self.features_dc[:, 0, :]

    @property
    def get_rgb(self) -> torch.Tensor:
        """[N, 3] DC converted to RGB."""
        return sh_ops.sh2rgb(self.get_colors)

    def get_covariance(self, scaling_modifier: float = 1.0) -> torch.Tensor:
        """[N, 6] packed covariance."""
        if scaling_modifier == 1.0:
            return self.covariance
        return self.covariance * (scaling_modifier * scaling_modifier)

    def get_full_covariance(self, scaling_modifier: float = 1.0) -> torch.Tensor:
        """[N, 3, 3] dense covariance."""
        return math3d.unpack_symmetric(self.get_covariance(scaling_modifier))

    # -------------------------------------------------------- constructors
    @classmethod
    def create(
        cls,
        xyz,
        features_dc,
        features_rest,
        opacity,
        scaling,
        rotation,
        sh_degree: int,
        covariance=None,
        dtype=torch.float32,
        device=None,
    ) -> "GaussianCloud":
        """Build from raw (pre-activation) arrays on `device` (default
        `cuda`); computes the covariance cache."""
        dev = resolve_device(device)

        def arr(a, *shape):
            return as_tensor(a, dev, dtype).reshape(*shape)

        n = len(xyz)
        k_rest = sh_ops.num_sh_coeffs(sh_degree) - 1
        xyz = arr(xyz, n, 3)
        features_dc = arr(features_dc, n, 1, 3)
        features_rest = arr(features_rest, n, k_rest, 3)
        opacity = arr(opacity, n, 1)
        scaling = arr(scaling, n, 3)
        rotation = arr(rotation, n, 4)
        if covariance is None:
            covariance = math3d.covariance_from_scaling_rotation(
                torch.exp(scaling), rotation
            )
        else:
            covariance = arr(covariance, n, 6)
        return cls(
            xyz=xyz,
            features_dc=features_dc,
            features_rest=features_rest,
            opacity=opacity,
            scaling=scaling,
            rotation=rotation,
            covariance=covariance,
            sh_degree=sh_degree,
        )

    @classmethod
    def from_numpy_dict(cls, d: dict, device=None) -> "GaussianCloud":
        """Inverse of `to_numpy_dict`, for this package's dict and for the
        JAX package's alike: the clouds render the same image. The SH degree
        follows from the `features_rest` width."""
        k_rest = int(np.shape(d["features_rest"])[1])
        sh_degree = math.isqrt(k_rest + 1) - 1
        if (sh_degree + 1) ** 2 != k_rest + 1:
            raise ValueError(f"features_rest has {k_rest} coefficients, "
                             "not (degree+1)^2 - 1 for any degree")
        return cls.create(
            xyz=d["xyz"], features_dc=d["features_dc"],
            features_rest=d["features_rest"], opacity=d["opacity"],
            scaling=d["scaling"], rotation=d["rotation"],
            sh_degree=sh_degree, device=device,
        )

    # ---------------------------------------------------------- transforms
    def transform(self, transformation, rotate_sh: bool = True) -> "GaussianCloud":
        """Apply a 4x4 SE(3) transform to the whole cloud: means get R x + t,
        covariances R Σ Rᵀ, orientations q_rot ⊗ q, and (with `rotate_sh`)
        the higher-order SH coefficients their Wigner-D rotation."""
        T = as_tensor(transformation, self.device, self.xyz.dtype)
        R = T[:3, :3]
        t = T[:3, 3]
        new_xyz = self.xyz @ R.T + t
        new_cov = math3d.transform_covariance(self.covariance, R)
        q_rot = math3d.rotmat_to_quat(R)
        new_rot = math3d.normalize(math3d.quat_multiply(q_rot[None, :], self.get_rotation))
        new_rest = (
            sh_ops.rotate_sh(self.features_rest, R, self.sh_degree)
            if rotate_sh
            else self.features_rest
        )
        return dataclasses.replace(
            self, xyz=new_xyz, covariance=new_cov, rotation=new_rot, features_rest=new_rest
        )

    def merge(self, other: "GaussianCloud", transformation=None) -> "GaussianCloud":
        """Concatenate two clouds, optionally transforming self first;
        requires equal SH degree."""
        if self.sh_degree != other.sh_degree:
            raise ValueError(
                f"SH degree mismatch: {self.sh_degree} vs {other.sh_degree}"
            )
        first = self if transformation is None else self.transform(transformation)
        return GaussianCloud(
            xyz=torch.cat([first.xyz, other.xyz]),
            features_dc=torch.cat([first.features_dc, other.features_dc]),
            features_rest=torch.cat([first.features_rest, other.features_rest]),
            opacity=torch.cat([first.opacity, other.opacity]),
            scaling=torch.cat([first.scaling, other.scaling]),
            rotation=torch.cat([first.rotation, other.rotation]),
            covariance=torch.cat([first.covariance, other.covariance]),
            sh_degree=self.sh_degree,
        )

    def select(self, indices) -> "GaussianCloud":
        """Gather a subset of splats."""
        fields = {f.name: getattr(self, f.name)[indices]
                  for f in dataclasses.fields(self) if f.name != "sh_degree"}
        return GaussianCloud(sh_degree=self.sh_degree, **fields)

    # -------------------------------------------------------------- export
    def to_numpy_dict(self) -> dict:
        """Raw arrays as numpy, in PLY-layout order."""
        return {
            name: getattr(self, name).detach().cpu().numpy()
            for name in ("xyz", "features_dc", "features_rest", "opacity",
                         "scaling", "rotation")
        }
