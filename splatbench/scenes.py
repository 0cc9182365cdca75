"""The benchmark's scenes, drawn from a seed.

Two forms of each draw:

- `uniform_draws_np`, `clustered_draws_np`, `random_cloud_np`,
  `hem_cloud_np`: frozen copies of the bench scenes' numpy draws at their
  fixed numpy seeds (bench.py's), bit for bit. They document where the
  render scene's distributions come from; the cells do not use them.
- `splat_scene`: what the render cells use. `uniform_draws_np`'s distributions,
  drawn on the device by one `torch.Generator` seeded with `--seed` (taken
  modulo 2**63, so any whole number is a seed), in a few large calls in a
  fixed order. The same seed on the same kind of device gives the same
  scene; a CPU stream and a CUDA stream differ.
- `reg_scene`: what the registration cells use: splats on the surfaces of
  a room the configuration fixes, drawn from `--seed` the same way.

Covariances are packed [xx, xy, xz, yy, yz, zz] of R diag(s)² Rᵀ with R
from the normalized quaternion (w, x, y, z), computed here, so the program
and the reference get the same raw inputs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# ------------------------------------------------------- frozen numpy draws


def uniform_draws_np(n):
    """The headline scene, numpy's default_rng(0): xyz, scales, quats,
    opacity logits, features (SH degree 0)."""
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    scales = rng.uniform(0.002, 0.006, size=(n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    logits = rng.normal(0.0, 1.0, size=n)
    features = (rng.normal(size=(n, 1, 3)) * 0.3).astype(np.float32)
    return xyz, scales, quats, logits, features


def clustered_draws_np(n):
    """The clustered scene, default_rng(7): splats on 2000 cluster
    surfaces, log-uniform mixed scales, opaque fronts."""
    rng = np.random.default_rng(7)
    n_clusters = 2000
    centers = rng.uniform(-1, 1, size=(n_clusters, 3)).astype(np.float32)
    assign = rng.integers(0, n_clusters, size=n)
    xyz = (centers[assign] + rng.normal(0, 0.045, size=(n, 3))).astype(np.float32)
    scales = np.exp(rng.uniform(np.log(0.0015), np.log(0.012), size=(n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    logits = rng.normal(1.2, 0.8, size=n)
    features = (rng.normal(size=(n, 1, 3)) * 0.3).astype(np.float32)
    return xyz, scales, quats, logits, features


def random_cloud_np(rng, n, sh_degree, scale_range):
    """The random splat cloud's raw arrays, in the draw order of the bench
    scenes: xyz, features_dc, features_rest, opacity logits, log-scales,
    quaternions."""
    k_rest = (sh_degree + 1) ** 2 - 1
    quats = rng.normal(size=(n, 4))
    return {
        "xyz": rng.normal(size=(n, 3)).astype(np.float32),
        "features_dc": rng.normal(size=(n, 1, 3)).astype(np.float32) * 0.5,
        "features_rest": rng.normal(size=(n, k_rest, 3)).astype(np.float32) * 0.1,
        "opacity": rng.normal(size=(n, 1)).astype(np.float32),
        "scaling": np.log(rng.uniform(*scale_range, size=(n, 3))).astype(np.float32),
        "rotation": quats.astype(np.float32),
    }


def hem_cloud_np(n):
    """The registration scene, default_rng(3): SH degree 1, scales 0.04-0.10."""
    return random_cloud_np(np.random.default_rng(3), n, 1, (0.04, 0.10))


# ------------------------------------------------------------ device draws


def generator(seed: int, device) -> torch.Generator:
    """The run's generator on `device`, seeded with `seed` modulo 2**63."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


def covariance(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """Packed covariances [N, 6] of R diag(scales)² Rᵀ, elementwise."""
    q = quats / torch.clamp_min(torch.linalg.vector_norm(quats, dim=-1, keepdim=True), 1e-12)
    w, x, y, z = q.unbind(-1)
    R = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(-1, 3, 3)
    M = R * scales[:, None, :]
    cov = (M[:, :, None, :] * M[:, None, :, :]).sum(-1)             # M Mᵀ, elementwise
    return torch.stack([cov[:, 0, 0], cov[:, 0, 1], cov[:, 0, 2],
                        cov[:, 1, 1], cov[:, 1, 2], cov[:, 2, 2]], dim=-1)


def splat_scene(spec: dict, seed: int, device) -> tuple:
    """(means [N, 3], cov6 [N, 6], opacity [N], features [N, K, 3]) of the
    "uniform" scene (`spec`: splats, sh_degree, xyz_range, scale_range,
    dc_std, rest_std, opacity_logit_std), in this draw order: xyz, scales,
    quaternions, opacity logits, features."""
    if spec["draw"] != "uniform":
        raise ValueError(f"unknown splat scene draw {spec['draw']!r}")
    n = int(spec["splats"])
    g = generator(seed, device)
    lo, hi = spec["xyz_range"]
    xyz = torch.rand((n, 3), generator=g, device=device) * (hi - lo) + lo
    s_lo, s_hi = spec["scale_range"]
    scales = torch.rand((n, 3), generator=g, device=device) * (s_hi - s_lo) + s_lo
    quats = torch.randn((n, 4), generator=g, device=device)
    logits = torch.randn((n,), generator=g, device=device) * spec["opacity_logit_std"]
    k = (int(spec["sh_degree"]) + 1) ** 2
    features = torch.randn((n, k, 3), generator=g, device=device)
    features[:, :1] *= spec["dc_std"]
    features[:, 1:] *= spec["rest_std"]
    return xyz, covariance(scales, quats), torch.sigmoid(logits), features


def _faces(spec: dict) -> np.ndarray:
    """Every face of the room's boxes as rows [centre (3), normal (3),
    first tangent (3), half extents (2)]: the room's own box (`room`, its
    sizes, centred at the origin) and each furniture box of `boxes`
    ([cx, cy, cz, sx, sy, sz])."""
    boxes = [[0.0, 0.0, 0.0, *spec["room"]]] + [list(b) for b in spec["boxes"]]
    rows = []
    for cx, cy, cz, *size in boxes:
        c, half = np.array([cx, cy, cz], np.float64), np.array(size, np.float64) / 2
        for axis in range(3):
            a, b = (axis + 1) % 3, (axis + 2) % 3
            for sign in (1.0, -1.0):
                n, t = np.zeros(3), np.zeros(3)
                n[axis], t[a] = sign, 1.0
                rows.append([*(c + n * half[axis]), *n, *t, half[a], half[b]])
    return np.array(rows, np.float64)


def _quat_of(m: np.ndarray) -> np.ndarray:
    """The unit quaternion (w, x, y, z) of the rotation matrix `m`."""
    w = math.sqrt(max(0.0, 1.0 + m[0, 0] + m[1, 1] + m[2, 2])) / 2
    x = math.copysign(math.sqrt(max(0.0, 1.0 + m[0, 0] - m[1, 1] - m[2, 2])) / 2, m[2, 1] - m[1, 2])
    y = math.copysign(math.sqrt(max(0.0, 1.0 - m[0, 0] + m[1, 1] - m[2, 2])) / 2, m[0, 2] - m[2, 0])
    z = math.copysign(math.sqrt(max(0.0, 1.0 - m[0, 0] - m[1, 1] + m[2, 2])) / 2, m[1, 0] - m[0, 1])
    return np.array([w, x, y, z])


def reg_scene(spec: dict, splats: int, seed: int, device) -> dict:
    """The raw arrays of the "room" capture: `splats` flat splats on the
    faces of a room and its furniture boxes (`spec`: room, boxes,
    sh_degree, tangent_scale, normal_scale, normal_jitter, dc_std,
    rest_std, opacity_logit_std), each lying in its face with a random
    spin, plus the packed `covariance`. The room is fixed by the
    configuration; the seed draws, in this order: each splat's face (by
    area), its place on the face, its offset along the normal, its three
    scales, its spin, DC colour, rest coefficients and opacity logit."""
    if spec["draw"] != "room":
        raise ValueError(f"unknown registration scene draw {spec['draw']!r}")
    n = int(splats)
    k_rest = (int(spec["sh_degree"]) + 1) ** 2 - 1
    faces = _faces(spec)
    normal, tangent = faces[:, 3:6], faces[:, 6:9]
    frames = np.stack([tangent, np.cross(normal, tangent), normal], axis=-1)    # columns
    qf = torch.tensor(np.array([_quat_of(f) for f in frames]), dtype=torch.float32, device=device)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    centre, nrm, t1 = f32(faces[:, 0:3]), f32(normal), f32(tangent)
    t2, half = f32(np.cross(normal, tangent)), f32(faces[:, 9:11])
    g = generator(seed, device)
    area = half[:, 0] * half[:, 1]
    face = torch.multinomial(area / area.sum(), n, replacement=True, generator=g)
    uv = (torch.rand((n, 2), generator=g, device=device) * 2 - 1) * half[face]
    off = torch.randn((n, 1), generator=g, device=device) * spec["normal_jitter"]
    xyz = centre[face] + uv[:, :1] * t1[face] + uv[:, 1:] * t2[face] + off * nrm[face]
    (t_lo, t_hi), (n_lo, n_hi) = spec["tangent_scale"], spec["normal_scale"]
    u = torch.rand((n, 3), generator=g, device=device)
    scales = torch.cat([u[:, :2] * (t_hi - t_lo) + t_lo, u[:, 2:] * (n_hi - n_lo) + n_lo], 1)
    spin = torch.rand((n,), generator=g, device=device) * math.pi     # half the angle
    c, s = torch.cos(spin), torch.sin(spin)
    w1, x1, y1, z1 = qf[face].unbind(-1)
    quats = torch.stack([w1 * c - z1 * s, x1 * c + y1 * s, y1 * c - x1 * s, z1 * c + w1 * s], -1)
    dc = torch.randn((n, 1, 3), generator=g, device=device) * spec["dc_std"]
    rest = torch.randn((n, k_rest, 3), generator=g, device=device) * spec["rest_std"]
    opacity = torch.randn((n, 1), generator=g, device=device) * spec["opacity_logit_std"]
    return {"xyz": xyz, "features_dc": dc, "features_rest": rest, "opacity": opacity,
            "scaling": torch.log(scales), "rotation": quats,
            "covariance": covariance(scales, quats)}


def rigid_motions(seed: int, count: int, translation: float, angle_deg: float):
    """`count` 4x4 float64 rigid motions drawn from `seed` by numpy, each a
    rotation by exactly `angle_deg` about a uniform random axis and a
    translation of norm exactly `translation` in a uniform random direction:
    every seed gets motions of the same sizes, in other directions."""
    rng = np.random.default_rng(int(seed) % (2 ** 63))
    angle = math.radians(angle_deg)
    out = []
    for _ in range(count):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        d = rng.normal(size=3)
        Kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
        T = np.eye(4)
        T[:3, :3] = np.eye(3) + math.sin(angle) * Kx + (1 - math.cos(angle)) * (Kx @ Kx)
        T[:3, 3] = d / np.linalg.norm(d) * translation
        out.append(T)
    return out


def move_capture(raw: dict, motion: np.ndarray) -> dict:
    """The capture's raw arrays moved by the 4x4 `motion`: positions and
    covariances (R Σ Rᵀ); quaternions are left as drawn, since the packed
    covariance is passed on with the capture."""
    dev = raw["xyz"].device
    R = torch.as_tensor(motion[:3, :3], dtype=torch.float32, device=dev)
    t = torch.as_tensor(motion[:3, 3], dtype=torch.float32, device=dev)
    xyz = (R[None] * raw["xyz"][:, None, :]).sum(-1) + t
    c = raw["covariance"]
    S = torch.stack([c[:, 0], c[:, 1], c[:, 2], c[:, 1], c[:, 3], c[:, 4],
                     c[:, 2], c[:, 4], c[:, 5]], dim=-1).reshape(-1, 3, 3)
    RS = (R[None, :, :, None] * S[:, None, :, :]).sum(2)               # R S
    RSR = (RS[:, :, None, :] * R[None, None, :, :]).sum(-1)            # R S Rᵀ
    cov = torch.stack([RSR[:, 0, 0], RSR[:, 0, 1], RSR[:, 0, 2],
                       RSR[:, 1, 1], RSR[:, 1, 2], RSR[:, 2, 2]], dim=-1)
    return {**raw, "xyz": xyz, "covariance": cov}
