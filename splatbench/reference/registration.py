"""The registration cells' plain reference, on the clouds' device.

- HEM: the frozen copy of the port's HEM (`frozen/hem.py`, float32 with
  TF32 off). HEM has no independent form: which splats become parents is
  a random draw, and which children each parent takes follows from the
  order and the exact candidate sets of its search, so any other code
  gives other levels.
- Everything after HEM is written here, apart from the port: the voxel
  pyramid (points averaged per occupied voxel of a grid anchored at the
  cloud's minimum), and point-to-point ICP as the app runs it through
  Open3D: each source point's exact nearest target point by a brute
  sweep, the pairs within the scale's gate, the rigid fit of those pairs
  in closed form by an SVD (Kabsch), and the configuration's stopping
  rule: Open3D's test (the fitness and the inlier RMSE at a pose each
  within 1e-6 of those at the pose before it), read one update later than
  Open3D reads it, or the scale's iteration budget. It runs in float64;
  the control runs it in float32 with TF32 matmuls.

Nothing of the port is imported: the clouds are built here from the same
raw arrays the program gets."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from splatbench.reference.frozen import hem, parameters


@dataclasses.dataclass(frozen=True)
class Capture:
    """What HEM reads of a splat capture: positions, DC colours, activated
    opacities, packed covariances and the SH rest coefficients."""

    xyz: torch.Tensor
    features_dc: torch.Tensor
    features_rest: torch.Tensor
    opacity: torch.Tensor
    covariance: torch.Tensor

    @property
    def num_points(self) -> int:
        return int(self.xyz.shape[0])

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    @property
    def get_colors(self) -> torch.Tensor:
        return self.features_dc[:, 0, :]

    @property
    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity)

    def get_covariance(self) -> torch.Tensor:
        return self.covariance


@dataclasses.dataclass
class Result:
    transformation: np.ndarray
    fitness: float
    inlier_rmse: float
    iterations: list


def voxel_downsample(points: torch.Tensor, voxel: float) -> torch.Tensor:
    """One point per occupied voxel, the mean of its points; the grid's
    corner is the cloud's minimum."""
    ijk = torch.floor((points - points.min(dim=0).values) / voxel).to(torch.int64)
    _, inverse = torch.unique(ijk, dim=0, return_inverse=True)
    n = int(inverse.max()) + 1
    sums = torch.zeros((n, 3), dtype=points.dtype, device=points.device).index_add_(0, inverse, points)
    counts = torch.bincount(inverse, minlength=n).to(points.dtype)
    return sums / counts[:, None]


def nearest(p: torch.Tensor, q: torch.Tensor, block: int = 8192) -> tuple:
    """(squared distance, index) of each row of `p`'s nearest row of `q`,
    by a brute sweep over blocks of `p`; the distance is taken again from
    the difference of the pair."""
    qq = (q * q).sum(1)
    idx = torch.empty(p.shape[0], dtype=torch.int64, device=p.device)
    for s in range(0, p.shape[0], block):
        pb = p[s:s + block]
        d2 = (pb * pb).sum(1)[:, None] - 2.0 * (pb @ q.T) + qq[None, :]
        idx[s:s + block] = torch.argmin(d2, dim=1)
    return ((p - q[idx]) ** 2).sum(1), idx


def kabsch(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The rigid 4x4 that moves the points `p` closest to `q` in the least
    squares sense (Kabsch, by an SVD of the cross-covariance)."""
    pc, qc = p.mean(0), q.mean(0)
    U, _, Vh = torch.linalg.svd((p - pc).T @ (q - qc))
    d = torch.sign(torch.linalg.det(Vh.T @ U.T))
    D = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    R = Vh.T @ D @ U.T
    T = torch.eye(4, dtype=p.dtype, device=p.device)
    T[:3, :3], T[:3, 3] = R, qc - R @ pc
    return T


def icp(src: torch.Tensor, tgt: torch.Tensor, gate: float, iterations: int, T: torch.Tensor,
        relative_fitness: float = 1e-6, relative_rmse: float = 1e-6, late_stop: bool = True) -> tuple:
    """Point-to-point ICP from the pose `T`: (pose, fitness, inlier RMSE at
    that pose, updates made). Open3D stops right after the update whose new
    pose scores (fitness and inlier RMSE) within the thresholds of the pose
    before it; with `late_stop` (the configuration's rule) the test is read
    one update later: it stops after the update that follows two such
    poses."""

    def score(T):
        p = src @ T[:3, :3].T + T[:3, 3]
        d2, idx = nearest(p, tgt)
        m = d2 <= gate * gate
        k = int(m.sum())
        rmse = float(torch.sqrt(d2[m].sum() / k)) if k else 0.0
        return p, idx, m, k / src.shape[0], rmse

    p, idx, m, fit, rmse = score(T)
    done, settled = 0, False
    while done < iterations:
        if not bool(m.any()):
            break
        T = kabsch(p[m], tgt[idx[m]]) @ T
        done += 1
        if settled:
            break
        p, idx, m, new_fit, new_rmse = score(T)
        settled = abs(new_fit - fit) < relative_fitness and abs(new_rmse - rmse) < relative_rmse
        fit, rmse = new_fit, new_rmse
        if settled and not late_stop:
            break
    if late_stop and settled:
        p, idx, m, fit, rmse = score(T)
    return T, fit, rmse, done


class Reference:
    """Registration jobs computed by the reference, with the program's
    interface, so that the control can stand in the program's place.
    `dtype` is the precision of everything after HEM."""

    def __init__(self, cfg: dict, device, dtype=torch.float64, late_stop: bool = True):
        self.device, self.dtype, self.late_stop = device, dtype, late_stop
        self.hem_params = parameters.GaussianMixtureParams(**cfg["hem"])
        ms = cfg["multiscale"]
        self.scales = list(zip(ms["voxel_values"], ms["iter_values"]))

    def cloud(self, raw: dict) -> Capture:
        f32 = lambda a: a.to(device=self.device, dtype=torch.float32)  # noqa: E731
        return Capture(xyz=f32(raw["xyz"]), features_dc=f32(raw["features_dc"]),
                       features_rest=f32(raw["features_rest"]), opacity=f32(raw["opacity"]),
                       covariance=f32(raw["covariance"]))

    def hem(self, cloud: Capture, seed: int):
        return hem.create_mixture(cloud, self.hem_params, seed=seed, backend="torch")

    def pyramid(self, cloud: Capture, levels) -> list:
        """The positions of level 0 (the capture) and of each HEM level."""
        return [self.points(cloud)] + [torch.as_tensor(np.asarray(lv.xyz), dtype=self.dtype,
                                                       device=self.device) for lv in levels]

    def points(self, cloud: Capture) -> torch.Tensor:
        return cloud.xyz.to(self.dtype)

    def _result(self, T, fit, rmse, done) -> Result:
        return Result(transformation=T.double().cpu().numpy(), fitness=fit, inlier_rmse=rmse,
                      iterations=done)

    def mixture_registration(self, src_levels, tgt_levels) -> Result:
        """The levels coarsest first: scale i registers level -(i+1) of each
        pyramid with the scale's gate and budget, from the pose before."""
        T = torch.eye(4, dtype=self.dtype, device=self.device)
        fit, rmse, done = 0.0, 0.0, []
        for i, (gate, iters) in enumerate(self.scales):
            T, fit, rmse, n = icp(src_levels[-(i + 1)], tgt_levels[-(i + 1)], gate, iters, T,
                                  late_stop=self.late_stop)
            done.append(n)
        return self._result(T, fit, rmse, done)

    def voxel_registration(self, src: torch.Tensor, tgt: torch.Tensor) -> Result:
        """Each scale registers the two clouds downsampled at its voxel
        size, with the voxel size as the gate, from the pose before."""
        T = torch.eye(4, dtype=self.dtype, device=self.device)
        fit, rmse, done = 0.0, 0.0, []
        for voxel, iters in self.scales:
            T, fit, rmse, n = icp(voxel_downsample(src, voxel), voxel_downsample(tgt, voxel),
                                  voxel, iters, T, late_stop=self.late_stop)
            done.append(n)
        return self._result(T, fit, rmse, done)
