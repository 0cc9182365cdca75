"""Scenes, tile sets and shared checks of the PyTorch/CUDA port's tests and
card drives.

The tier-1 tests, the card tests (`pytest -m card`), `chip_smoke.py`,
`bench_torch.py` and `scripts/` take their inputs from here: bench.py's
draws (each config's scene, in bench.py's order), the bench frame and
bench.py config 5's frame, seeded and adversarial tile sets for the
composite kernels, the kNN kernel's cases, the tile table's inputs at the
benchmark cells' shapes, the demo pair's photometric views, and the
comparisons the card checks share (pose errors, the compositor's pair
counts, the tile table's equality). It also holds the two-thread cap every
port test file runs under (`two_torch_threads`).

It imports no JAX, neither `chip_smoke` nor `bench_torch`, and only
public names of `splatbench`.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import struct
import subprocess
import zlib

import numpy as np
import pytest
import torch

from gaussiansplattingregistration_tpu_torch.models.camera import Camera
from gaussiansplattingregistration_tpu_torch.models.gaussian_cloud import GaussianCloud
from gaussiansplattingregistration_tpu_torch.models.point_cloud import PointCloud
from gaussiansplattingregistration_tpu_torch.ops import math3d, se3
from gaussiansplattingregistration_tpu_torch.ops import raster_cuda as RC
from gaussiansplattingregistration_tpu_torch.ops import rasterize as R
from gaussiansplattingregistration_tpu_torch.ops.rasterize import RasterizeConfig

REPO = os.path.dirname(os.path.abspath(__file__))
# Bench scene and config (bench.py): 1M splats, SH degree 0, 1280x720, 70°.
WIDTH, HEIGHT, N_SPLATS = 1280, 720, 1_000_000
# The projection's outputs the tile table is built from, in its argument order.
TABLE_INPUTS = ("means2d", "radius", "depth", "valid")


@pytest.fixture(scope="module")
def two_torch_threads():
    """Two torch intra-op threads for a test module. The tier-1 command runs
    six pytest workers on one host; torch's default of one thread per core
    in every worker oversubscribes the CPU several times over and slows
    every worker down. A module opts in with `pytestmark =
    pytest.mark.usefixtures("two_torch_threads")` after importing this
    fixture; at module scope it also covers the module's other
    module-scoped fixtures."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def card_line(dev) -> str:
    """The card's name and power limit as nvidia-smi prints them, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# ------------------------------------------------------- bench.py's draws

def uniform_draws(n):
    """The headline scene (bench.py:57-71), numpy's default_rng(0): xyz,
    scales, quats, opacity logits, features (SH degree 0). Sized so splats
    are a few pixels across at 720p."""
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    scales = rng.uniform(0.002, 0.006, size=(n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    logits = rng.normal(0.0, 1.0, size=n)
    features = (rng.normal(size=(n, 1, 3)) * 0.3).astype(np.float32)
    return xyz, scales, quats, logits, features


def clustered_draws(n):
    """The clustered scene (bench.py:205-224), default_rng(7): splats on
    2000 cluster surfaces, log-uniform mixed scales, opaque fronts."""
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


def splat_arrays(draws, dev):
    """(means, cov3d, opacity, features) on `dev` from a scene's draws."""
    xyz, scales, quats, logits, features = draws
    opacity = (1.0 / (1.0 + np.exp(-logits))).astype(np.float32)
    cov = math3d.covariance_from_scaling_rotation(
        torch.as_tensor(scales, device=dev), torch.as_tensor(quats, device=dev))
    return (torch.as_tensor(xyz, device=dev), cov, torch.as_tensor(opacity, device=dev),
            torch.as_tensor(features, device=dev))


def two_clouds(rng, n, offset=(0.08, -0.05, 0.04), angle=0.06, colors=False):
    """bench.py's `_two_clouds` draws as numpy: a wavy surface `tgt`, its
    copy `src` = R tgt + offset (R about z by `angle`), colors or None, and
    the 4x4 T_src with src = T_src tgt."""
    pts = rng.uniform(-1.0, 1.0, size=(n, 3)).astype(np.float32)
    pts[:, 2] = 0.3 * np.sin(3.0 * pts[:, 0]) + 0.2 * np.cos(2.0 * pts[:, 1])
    pts[:, 2] += 0.01 * rng.normal(size=n).astype(np.float32)
    c, s = math.cos(angle), math.sin(angle)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    src = pts @ rot.T + np.asarray(offset, np.float32)
    col = (0.5 + 0.5 * np.sin(5.0 * pts)).astype(np.float32) if colors else None
    T_src = np.eye(4)
    T_src[:3, :3], T_src[:3, 3] = rot, offset
    return src, pts, col, T_src


def random_cloud(rng, n, sh_degree, scale_range, dev):
    """tests/scene_utils.py's `make_random_cloud` draws, as a port cloud."""
    k_rest = (sh_degree + 1) ** 2 - 1
    quats = rng.normal(size=(n, 4))
    return GaussianCloud.create(
        xyz=rng.normal(size=(n, 3)).astype(np.float32),
        features_dc=rng.normal(size=(n, 1, 3)).astype(np.float32) * 0.5,
        features_rest=rng.normal(size=(n, k_rest, 3)).astype(np.float32) * 0.1,
        opacity=rng.normal(size=(n, 1)).astype(np.float32),
        scaling=np.log(rng.uniform(*scale_range, size=(n, 3))).astype(np.float32),
        rotation=quats.astype(np.float32),
        sh_degree=sh_degree, device=dev,
    )


def point_cloud(points, colors=None, dev="cuda"):
    return PointCloud(points=torch.as_tensor(points, device=dev),
                      colors=None if colors is None else torch.as_tensor(colors, device=dev))


def icp_draws(n):
    """Config 1's clouds (bench.py:302-303, 320-322), default_rng(1): the
    surface pair of `two_clouds` (src, tgt, T_src), then a volumetric cloud
    `vol` and its copy `vol_src` = T_vol vol."""
    rng = np.random.default_rng(1)
    src, tgt, _, T_src = two_clouds(rng, n)
    vol = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    T_vol = se3.se3_exp(torch.tensor([0.01, -0.02, 0.01, 0.03, -0.02, 0.01])).numpy()
    vol_src = (vol @ T_vol[:3, :3].T + T_vol[:3, 3]).astype(np.float32)
    return src, tgt, T_src, vol_src, vol, T_vol


def global_draws(n):
    """Config 2's colored pair (bench.py:362-363), default_rng(2): src,
    tgt, colors, T_src as `two_clouds` returns them."""
    return two_clouds(np.random.default_rng(2), n, offset=(0.3, -0.2, 0.15), angle=0.4,
                      colors=True)


def hem_cloud(n, dev):
    """Config 3's splats (bench.py:416-427), default_rng(3): SH degree 1,
    scales 0.04-0.10."""
    return random_cloud(np.random.default_rng(3), n, 1, (0.04, 0.10), dev)


def photometric_cloud(n, dev):
    """Config 5's splats (bench.py:509-511), default_rng(4): SH degree 1,
    scales 0.005-0.02."""
    return random_cloud(np.random.default_rng(4), n, 1, (0.005, 0.02), dev)


def photometric_camera(dev, position=(0.0, 0.0, 3.0), width=640, height=360):
    """Config 5's camera: `width` x `height` (640x360) at 70°, looking
    down z."""
    f = width / (2 * math.tan(math.radians(70) / 2))
    return Camera.create(np.eye(3), list(position), f, f, width, height, device=dev)


def photometric_config():
    """Config 5's rasterizer config (bench.py:514-517) on backend "cuda"."""
    return RasterizeConfig(max_tiles_per_splat=4, max_splats_per_tile=256, tile_chunk=32,
                           max_bwd_splats_per_tile=256, backend="cuda")


# ------------------------------------------------- the frames of the drives

def bench_camera(dev):
    f = WIDTH / (2 * math.tan(math.radians(70) / 2))
    return Camera.create(np.eye(3), [0.0, 0.0, 3.0], f, f, WIDTH, HEIGHT, device=dev)


def bench_config():
    return RasterizeConfig(max_tiles_per_splat=4, max_splats_per_tile=384,
                           tile_chunk=32, max_live_tiles=2688, backend="cuda")


def bench_scene(dev):
    """The bench scene (bench.py) on `dev`: (rasterize_arrays arguments,
    config)."""
    cam = bench_camera(dev)
    args = (*splat_arrays(uniform_draws(N_SPLATS), dev), cam.viewmat, cam.intrinsics,
            WIDTH, HEIGHT, 0, torch.zeros(3, device=dev))
    return args, bench_config()


def bench_cloud(dev):
    """The bench scene's splats as a GaussianCloud (the same draws)."""
    xyz, scales, quats, logits, features = uniform_draws(N_SPLATS)
    return GaussianCloud.create(xyz, features, np.zeros((N_SPLATS, 0, 3), np.float32),
                                logits, np.log(scales), quats, sh_degree=0, device=dev)


def sharded_step_camera(dev):
    """The second camera of `chip_smoke.py`'s sharded train step: the bench
    camera moved by (0.05, -0.03)."""
    f = WIDTH / (2 * math.tan(math.radians(70) / 2))
    return Camera.create(np.eye(3), [0.05, -0.03, 3.0], f, f, WIDTH, HEIGHT, device=dev)


def frame_args(cloud, cam):
    """`rasterize_arrays`' arguments for `cloud` seen from `cam`, black
    background."""
    return (cloud.xyz, cloud.covariance, cloud.get_opacity[:, 0], cloud.get_features,
            cam.viewmat, cam.intrinsics, cam.width, cam.height, cloud.sh_degree,
            torch.zeros(3, device=cloud.xyz.device))


def config5_scene(dev):
    """bench.py config 5's scene (`bench_photometric`): 100k splats of SH
    degree 1 from default_rng(4), a 640x360 camera at 70° and its config
    (max_tiles_per_splat=4, K=256) on backend "cuda"; a second camera
    moved 0.05 sideways for the train step."""
    cams = [photometric_camera(dev, pos) for pos in ((0.0, 0.0, 3.0), (0.05, -0.03, 3.0))]
    return photometric_cloud(100_000, dev), cams, photometric_config()


def config5_frame(dev) -> tuple:
    """(rasterize_arrays arguments, config) of config 5's first camera."""
    cloud, cams, cfg = config5_scene(dev)
    return frame_args(cloud, cams[0]), cfg


# ------------------------------------------------------ composite kernels

def random_tiles(rng, counts, K: int, device):
    """Seeded [T, 10, K] tile params shaped like the gather's output: slots
    past counts[t] are zero. Every fourth tile holds large splats of opacity
    0.998-1 centred within 0.05 px of a pixel centre, so its pixels saturate
    within the first chunk and some raw alphas reach alpha_max (0.999): the
    backward's clamp branch."""
    T = len(counts)
    big = (np.arange(T) % 4 == 0)[:, None]
    var_x = np.where(big, rng.uniform(40, 200, (T, K)), rng.uniform(0.5, 30, (T, K)))
    var_y = np.where(big, rng.uniform(40, 200, (T, K)), rng.uniform(0.5, 30, (T, K)))
    cov_xy = rng.uniform(-0.7, 0.7, (T, K)) * np.sqrt(var_x * var_y)
    det = var_x * var_y - cov_xy ** 2
    mx, my = rng.uniform(-4, 20, (T, K)), rng.uniform(-4, 20, (T, K))
    centred = rng.uniform(-0.05, 0.05, (2, T, K))
    g = np.stack([
        np.where(big, np.floor(mx) + 0.5 + centred[0], mx),
        np.where(big, np.floor(my) + 0.5 + centred[1], my),
        var_y / det, -cov_xy / det, var_x / det,
        np.where(big, rng.uniform(0.998, 1.0, (T, K)), rng.uniform(0.05, 0.95, (T, K))),
        rng.uniform(0, 1, (T, K)), rng.uniform(0, 1, (T, K)), rng.uniform(0, 1, (T, K)),
        rng.uniform(1, 5, (T, K)),
    ], axis=1)
    g *= (np.arange(K)[None, :] < np.asarray(counts)[:, None])[:, None, :]
    cnt = torch.tensor(counts, dtype=torch.float32, device=device)[:, None]
    return torch.tensor(g, dtype=torch.float32, device=device), cnt


def adversarial_tiles(rng, offsets, device, K: int = 64):
    """[16, 10, K] tiles that probe the kernels' footprint culling
    (csrc/tile_footprint.cuh), four tiles of each kind:
    0-3  each entry puts one pixel centre at sigma = s_max (1 + r), with
         s_max = ln(op / alpha_clip) the visibility edge and r cycling
         through `offsets`; every eighth conic a needle (|corr| 0.995);
    4-7  opacity at alpha_clip, one f32 step below and one above, the mean
         on a pixel centre;
    8-11 conics that are not positive definite (indefinite, a < 0, a = b = 0,
         det = 0, negative definite), means off the grid so that no pixel
         centre has |sigma| < 1e-3;
    12-15 means off the tile with footprints reaching in, half of them with
         an edge pixel at the visibility edge.
    Counts are K, except tile 1 (40) and tile 13 (17); slots past them are
    zero. Returns (gT, counts [16, 1]) on `device`."""
    f32 = np.float32
    clip = f32(1.0 / 255.0)
    centres = np.stack(np.meshgrid(np.arange(16) + 0.5, np.arange(16) + 0.5), -1).reshape(-1, 2)

    def pd_conic(lo, hi, corr):
        vx, vy = rng.uniform(lo, hi, 2)
        cov = corr * np.sqrt(vx * vy)
        det = vx * vy - cov * cov
        return vy / det, -cov / det, vx / det

    def sigma(mean, a, b, c):
        d = centres - np.asarray(mean, np.float64)
        return 0.5 * (a * d[:, 0] ** 2 + c * d[:, 1] ** 2) + b * d[:, 0] * d[:, 1]

    def at_edge(pixel, u, a, b, c, op, r):
        """The mean at which `pixel` sits at sigma = s_max (1 + r) along u."""
        a, b, c, op = (float(f32(v)) for v in (a, b, c, op))
        s = np.log(op / float(clip))
        q = 0.5 * (a * u[0] ** 2 + 2 * b * u[0] * u[1] + c * u[1] ** 2)
        return np.asarray(pixel) + np.sqrt(s * (1 + r) / q) * np.asarray(u)

    rows = []
    for t in range(16):
        kind = t // 4
        for k in range(K):
            if kind == 0:
                corr = rng.choice([-0.995, 0.995]) if k % 8 == 0 else rng.uniform(-0.9, 0.9)
                a, b, c = pd_conic(0.5, 30, corr)
                op = rng.uniform(0.05, 0.5)
                th = rng.uniform(0, 2 * np.pi)
                mean = at_edge(centres[rng.integers(256)], (np.cos(th), np.sin(th)),
                               a, b, c, op, offsets[k % len(offsets)])
            elif kind == 1:
                a, b, c = pd_conic(0.5, 30, rng.uniform(-0.9, 0.9))
                op = (clip, np.nextafter(clip, f32(0)), np.nextafter(clip, f32(1)))[k % 3]
                mean = centres[rng.integers(256)]
            elif kind == 2:
                op = rng.uniform(0.2, 0.6)
                while True:
                    form = k % 5
                    a, c = rng.uniform(0.05, 1.0, 2)
                    if form == 0:
                        b = rng.choice([-1, 1]) * rng.uniform(1.2, 2.0) * np.sqrt(a * c)
                    elif form == 1:
                        a, b = -a, rng.uniform(-0.3, 0.3)
                    elif form == 2:
                        a, b = 0.0, 0.0
                    elif form == 3:
                        a = c
                        b = a
                    else:
                        a, c, b = -a, -c, 0.0
                    mean = rng.uniform(0, 16, 2)
                    a, b, c = float(f32(a)), float(f32(b)), float(f32(c))
                    if np.abs(sigma(f32(mean), a, b, c)).min() > 1e-3:
                        break
            else:
                a, b, c = pd_conic(20, 300, rng.uniform(-0.8, 0.8))
                op = rng.uniform(0.2, 0.9)
                side = rng.integers(4)
                normal = ((-1, 0), (1, 0), (0, -1), (0, 1))[side]
                if k % 2:
                    along = rng.uniform(0, 16)
                    depth_out = rng.uniform(1, 30)
                    mean = {0: (-depth_out, along), 1: (16 + depth_out, along),
                            2: (along, -depth_out), 3: (along, 16 + depth_out)}[side]
                else:
                    i = rng.integers(16) + 0.5
                    pixel = {0: (0.5, i), 1: (15.5, i), 2: (i, 0.5), 3: (i, 15.5)}[side]
                    th = np.arctan2(normal[1], normal[0]) + rng.uniform(-1, 1)
                    mean = at_edge(pixel, (np.cos(th), np.sin(th)), a, b, c, op,
                                   offsets[(k // 2) % len(offsets)])
            rows.append([mean[0], mean[1], a, b, c, op, *rng.uniform(0, 1, 3),
                         rng.uniform(1, 5)])
    g = np.ascontiguousarray(np.asarray(rows, np.float64).reshape(16, K, 10)
                             .transpose(0, 2, 1), dtype=np.float32)
    counts = np.full(16, K)
    counts[1], counts[13] = 40, 17
    g *= (np.arange(K)[None, :] < counts[:, None])[:, None, :]
    cnt = torch.tensor(counts, dtype=torch.float32, device=device)[:, None]
    return torch.tensor(g, device=device), cnt


def kernel_inputs(args, cfg):
    """The composite kernel's inputs for the frame of `args`, built as
    rasterize_tile_slab builds them, with the stage intermediates."""
    means, cov, op, feats, viewmat, intr, W, H, deg, _ = args
    ts = cfg.tile_size
    tiles_x, tiles_y = -(-W // ts), -(-H // ts)
    T_live = R._row_cap(cfg, tiles_x * tiles_y)
    cam_center = -(viewmat[:3, :3].T @ viewmat[:3, 3])
    proj = R.project_gaussians(means, cov, viewmat, intr, W, H, cfg)
    colors = R.compute_view_colors(feats, means, cam_center, deg)
    table, _, _, counts, order, _ = R._build_tile_table(
        proj["means2d"], proj["radius"], proj["depth"], proj["valid"],
        tiles_x, tiles_y, cfg)
    packed = torch.cat([proj["means2d"], proj["conic"], (op * proj["valid"])[:, None],
                        colors, proj["depth"][:, None]], dim=-1)
    gT = R.gather_entries(packed, table[:T_live], cfg.max_tiles_per_splat)
    rows = order[:T_live].long()
    gT[:, 0, :] -= ((rows % tiles_x) * ts).float()[:, None]
    gT[:, 1, :] -= ((rows // tiles_x) * ts).float()[:, None]
    return {"proj": proj, "cam_center": cam_center, "packed": packed, "table": table,
            "T_live": T_live, "tiles": (tiles_x, tiles_y), "gT": gT,
            "cnt": counts[:T_live, None].float()}


def pair_counts(gT, cnt, ts: int, config, tiles_per_step: int = 256) -> dict:
    """The compositor's data-dependent work on (gT, cnt), counted over
    (pixel, entry) pairs with the entry inside its tile's count: `alive`,
    the pixel's transmittance before the entry above transmittance_min;
    `candidate`, alive pairs whose entry is on the list of the pixel's warp
    (`raster_cuda.entry_footprints` and the kernels' warp layout): the pairs
    the culled kernels test; `visible`, the pairs composited; `clamped`,
    visible pairs whose raw alpha reaches alpha_max. The transmittance is
    the forward twin's."""
    K, S = gT.shape[2], RC._CHUNK
    px, py = RC._pixel_centres(ts, gT)
    n = {"alive": 0, "candidate": 0, "visible": 0, "clamped": 0}
    for t0 in range(0, gT.shape[0], tiles_per_step):
        g = gT[t0:t0 + tiles_per_step]
        _, in_count = RC._in_count(cnt[t0:t0 + tiles_per_step], g.shape[0], K, g.device)
        listed = RC.warp_candidates(RC.entry_footprints(g, config), ts)   # [t, P, K]
        carry = torch.ones((g.shape[0], ts * ts), dtype=g.dtype, device=g.device)
        for c0 in range(0, K, S):
            inc = in_count[:, c0:c0 + S]
            *_, raw, alpha = RC._chunk_terms(g[:, :, c0:c0 + S], px, py, inc, config)
            lt = torch.log1p(-alpha)
            cum = torch.cumsum(lt, dim=2)
            alive = (carry[:, :, None] * torch.exp(cum - lt) > config.transmittance_min) \
                & inc[:, None, :]
            visible = alive & (alpha > 0)
            n["alive"] += int(alive.sum())
            n["candidate"] += int((alive & listed[:, :, c0:c0 + S]).sum())
            n["visible"] += int(visible.sum())
            n["clamped"] += int((visible & (raw >= config.alpha_max)).sum())
            carry = carry * torch.exp(cum[:, :, -1])
    return n


def max_errs(got, want):
    """Max abs error of (rgb, alpha, depth) and whether `live` is equal."""
    errs = [float((a - b).abs().max()) if a.numel() else 0.0
            for a, b in zip(got[:3], want[:3])]
    return errs, bool(torch.equal(got[3], want[3]))


def check_bwd(got, want, where: str) -> dict:
    """The backward kernel within 1e-3 of each channel's max abs in the
    twin: the JAX suite's gradient tolerance (tests/test_raster_pallas.py).
    Pixel sums run in another order, and the kernel's suffix is a total
    minus a prefix where the twin cumsums the chunk back to front. Raises
    on a channel past it or a value that is not finite."""
    err = (got - want).abs().amax(dim=(0, 2)).tolist()
    scale = want.abs().amax(dim=(0, 2)).tolist()
    if not all(e <= 1e-3 * s for e, s in zip(err, scale)):
        raise AssertionError(f"composite_bwd disagrees with its twin ({where}): {err} vs {scale}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"composite_bwd is not finite ({where})")
    return {"max_abs_err": err, "twin_max_abs": scale}


# ------------------------------------------------------------- kNN kernel

def sqdist_rows(query, data, idx):
    """[Q, k] squared distances of query i to data[idx[i, j]] on their
    device, summed as the brute form sums them."""
    nb = data[idx.reshape(-1)].reshape(*idx.shape, data.shape[1])
    acc = None
    for c in range(data.shape[1]):
        term = torch.sub(query[:, None, c], nb[..., c]).square_()
        acc = term if acc is None else acc.add_(term)
    return acc


def knn_kernel_cases(dev) -> list:
    """(name, query, data, k, timed) of the kNN kernel's checks on the card:
    `reg200k_hem`'s shapes (HEM's level-0 search, 66.5k x 200k at k = 32;
    the first level's normals and ICP, 68k x 68k at k = 30 and 1; the last
    level's ICP, 8.7k x 8.7k at k = 1, which splits the data), k = 20 and
    100, and the edges: N not a multiple of the staged chunk, k = N, fewer
    queries than a warp, HEM's dead rows at 1e12 (exact ties), duplicated
    points (exact ties at every rank) and D = 4. Points are uniform in a
    4 x 3 x 2.5 room, in random order, as the cell's splats are. `timed`
    marks the cell's shapes."""
    g = torch.Generator(device=dev)
    g.manual_seed(13)
    room = torch.tensor([4.0, 3.0, 2.5], device=dev)

    def pts(n, dim=3):
        return torch.rand((n, dim), generator=g, device=dev) * (room if dim == 3 else 1.0)

    def some(x, n):
        return x[torch.randperm(x.shape[0], generator=g, device=dev)[:n]].contiguous()

    lvl0, lvl1, lvl1_moved, lvl3 = pts(200_000), pts(68_000), pts(68_000), pts(8_700)
    far = pts(5000)
    far[torch.rand(5000, generator=g, device=dev) > 0.004] = 1e12    # ~20 alive rows
    dup = pts(3000)
    dup = torch.cat([dup, dup[:1500]])
    mid = pts(20_000)
    return [
        ("hem_level0_k32", some(lvl0, 66_500), lvl0, 32, True),
        ("normals_level1_k30", lvl1, lvl1, 30, True),
        ("icp_level1_k1", lvl1_moved, lvl1, 1, True),
        ("icp_level3_k1", pts(8_700), lvl3, 1, True),
        ("k20", mid, mid, 20, False),
        ("k100", some(mid, 5000), mid, 100, False),
        ("n_not_chunk_multiple", pts(1000), pts(3 * 512 + 17), 32, False),
        ("k_equals_n", pts(50), pts(100), 100, False),
        ("q_below_warp_k30", pts(7), pts(5000), 30, False),
        ("q_below_warp_k1", pts(7), pts(5000), 1, False),
        ("dead_rows_1e12_k32", some(pts(5000), 300), far, 32, False),
        ("dead_rows_1e12_k1", pts(300), far, 1, False),
        ("duplicates_k32", some(dup, 1000), dup, 32, False),
        ("duplicates_k1", some(dup, 1000), dup, 1, False),
        ("d4_k20", pts(3000, 4), pts(4000, 4), 20, False),
    ]


# ------------------------------------------------------------- tile table

def tile_bin_args(name: str, means, cov, view, intr, width: int, height: int, cfg) -> tuple:
    """(name, (means2d, radius, depth, valid), tiles_x, tiles_y, cfg): the
    tile table's inputs of a frame, projected as the rasterizer projects
    it."""
    proj = R.project_gaussians(means, cov, view, intr, width, height, cfg)
    ts = cfg.tile_size
    return (name, tuple(proj[k] for k in TABLE_INPUTS), -(-width // ts), -(-height // ts), cfg)


def port_config(rz: dict) -> RasterizeConfig:
    """The program's RasterizeConfig of a configuration's `rasterizer`
    fields, on the "cuda" backend, as the benchmark builds it."""
    fields = {f.name for f in dataclasses.fields(RasterizeConfig)}
    return RasterizeConfig(**{k: v for k, v in rz.items() if k in fields}, backend="cuda")


def tile_bin_cells(dev, seed: int = 123) -> list:
    """`tile_bin_args` of the tile table at the shapes of the two
    configurations that bin (splatbench's draws of `seed`):
    `photo_pair_step`'s first view (yaw 0 of the pair of 1.1M-splat room
    captures, 1557x1038, C=36, K=3072) and `splat1m_train` /
    `splat1m_view`'s first frame (1M splats, 1280x720, C=4, K=512,
    `max_live_tiles` 2688); then at the frames of `chip_smoke.py`'s main
    paths: the bench frame at `bench_config()` (the photometric, render and
    grad phases' frame, whose plain-backend comparisons bin on the card
    too), the viewer's default view of the bench cloud (its default config,
    C=16, K=256), the sharded train step's second camera and config 5's
    first camera (`config5_scene`)."""
    from gaussiansplattingregistration_tpu_torch.pipelines.viewer import ViewerScene
    from splatbench import scenes
    from splatbench.drivers.photometric import look_at_views
    from splatbench.reference import raster as ref_raster

    configs = os.path.join(REPO, "splatbench", "configs")
    photo = load_json(os.path.join(configs, "photo_pair1m_sh3_1557.json"))
    pair = [scenes.reg_scene(photo["scene"], photo["splats"], s, dev) for s in (seed, seed + 1)]
    means = torch.cat([p["xyz"] for p in pair])
    cov = torch.cat([p["covariance"] for p in pair])
    del pair
    cams = photo["cameras"]
    out = [tile_bin_args("photo_pair_step_view", means, cov, *look_at_views(cams, dev)[0],
                         int(cams["width"]), int(cams["height"]),
                         port_config(photo["rasterizer"]))]
    del means, cov
    splat = load_json(os.path.join(configs, "splat1m_sh3_720p.json"))
    cam = splat["camera"]
    W, H = int(cam["width"]), int(cam["height"])
    xyz, cov6, _, _ = scenes.splat_scene(splat["scene"], seed, dev)
    out.append(tile_bin_args("splat1m_frame", xyz, cov6,
                             *ref_raster.camera(0.0, W, H, cam["fov_deg"], cam["distance"], dev),
                             W, H, port_config(splat["rasterizer"])))
    del xyz, cov6
    cloud = bench_cloud(dev)
    viewer = ViewerScene(cloud, width=WIDTH, height=HEIGHT, device=dev)
    frames = (("bench_config", bench_scene(dev)),
              ("viewer_default", (frame_args(cloud, viewer.camera_for({}, WIDTH, HEIGHT)),
                                  viewer.config)),
              ("sharded_step_camera1", (frame_args(cloud, sharded_step_camera(dev)),
                                        bench_config())),
              ("config5", config5_frame(dev)))
    for name, (args, cfg) in frames:
        out.append(tile_bin_args(name, *args[:2], *args[4:8], cfg))
    return out


def tile_bin_compare(got, want) -> dict:
    """`tile_bin`'s outputs `got` against the plain form's `want`: the
    table, counts, order and counters equal, and the sorted entries equal
    the plain form's first E (past which it holds only empty slots)."""
    E = got[1].numel()
    stats = ({k: bool(torch.equal(got[5][k], want[5][k])) for k in want[5]}
             if want[5] is not None else {})
    rec = {"entries": E, "slots": want[1].numel(),
           "table_equal": bool(torch.equal(got[0], want[0])),
           "counts_equal": bool(torch.equal(got[3], want[3])),
           "order_equal": (got[4] is None and want[4] is None)
           or (got[4] is not None and want[4] is not None and bool(torch.equal(got[4], want[4]))),
           "sorted_entry_equal": bool(torch.equal(got[1], want[1][:E])),
           "stats_equal": all(stats.values()),
           "stats": {k: int(v) for k, v in (got[5] or {}).items()}}
    rec["equal"] = all(rec[k] for k in ("table_equal", "counts_equal", "order_equal",
                                         "sorted_entry_equal", "stats_equal"))
    return rec


# --------------------------------------------------------- the demo pair

def check_png(path: str, width: int, height: int) -> None:
    """Signature, IHDR size and the IDAT payload length of an 8-bit RGB PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG")
    w, h, depth, ctype = struct.unpack(">IIBB", data[16:26])
    if (w, h, depth, ctype) != (width, height, 8, 2):
        raise AssertionError(f"{path}: IHDR {w}x{h} depth {depth} type {ctype}")
    pos, idat = 8, b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + length]
        pos += 12 + length
    if len(zlib.decompress(idat)) != h * (1 + 3 * w):
        raise AssertionError(f"{path}: IDAT payload has the wrong size")


def demo_photometric_views(out_dir: str, size: int, device):
    """tests/test_e2e_cli.py's photometric scenario for the port's CLI: the
    demo pair merged under its true transform, rendered from three spread
    views at size x size into `out_dir`/view<i>.png with a 3DGS
    cameras.json. Returns (cameras.json path, init transform path, T_offset):
    the init is the true pose inv(T_offset) perturbed by a twist of norm
    ~0.02."""
    from gaussiansplattingregistration_tpu_torch.models.camera import look_at
    from gaussiansplattingregistration_tpu_torch.utils import io as gio
    from gaussiansplattingregistration_tpu_torch.utils.png import write_png

    data = os.path.join(REPO, "tests", "data")
    T_off = np.asarray(load_json(os.path.join(data, "demo_transform.json"))["T_offset"],
                       np.float64)
    source = gio.load_gaussian_cloud(os.path.join(data, "demo_source.ply"), device=device)
    target = gio.load_gaussian_cloud(os.path.join(data, "demo_target.ply"), device=device)
    scene = source.merge(target, np.linalg.inv(T_off))
    f = size / (2 * math.tan(math.radians(60) / 2))
    entries = []
    for i, eye in enumerate(((2.2, 1.4, 2.6), (-2.0, 0.8, 2.9), (0.4, -2.1, 2.7))):
        V = look_at(eye, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), zoom=float(np.linalg.norm(eye)),
                    forward="+z", device=device)
        cam = Camera.create(np.eye(3), np.zeros(3), f, f, size, size, device=device,
                            image_name=f"view{i}").with_viewmat(V)
        rgb, alpha, _ = R.rasterize(scene, cam, config=RasterizeConfig(), device=device)
        if not float(alpha.mean()) > 0.05:
            raise AssertionError(f"view {i} of the demo scene is nearly empty")
        write_png(os.path.join(out_dir, f"view{i}.png"),
                  (np.clip(rgb.cpu().numpy(), 0, 1) * 255).astype(np.uint8))
        c2w = np.linalg.inv(V.cpu().numpy().astype(np.float64))
        entries.append({"img_name": f"view{i}", "width": size, "height": size,
                        "fx": f, "fy": f, "rotation": c2w[:3, :3].tolist(),
                        "position": c2w[:3, 3].tolist()})
    cams_json = os.path.join(out_dir, "cameras.json")
    with open(cams_json, "w") as fh:
        json.dump(entries, fh)
    xi = torch.tensor([0.01, -0.008, 0.006, 0.008, -0.006, 0.01], dtype=torch.float64)
    init = se3.se3_exp(xi).numpy() @ np.linalg.inv(T_off)
    init_json = os.path.join(out_dir, "init.json")
    with open(init_json, "w") as fh:
        json.dump({"transformation": init.tolist()}, fh)
    return cams_json, init_json, T_off


def pose_error(T_est, T_off) -> float:
    """|se3_log(T_est @ T_offset)|: zero when T_est == inv(T_offset)."""
    residual = torch.as_tensor(np.asarray(T_est) @ np.asarray(T_off), dtype=torch.float32)
    return float(torch.linalg.norm(se3.se3_log(residual)))


def pose_err_parts(T_est, T_true):
    """(rotation error in rad, translation error) of T_est against T_true,
    as tests/test_goldens.py measures them."""
    Te, Tt = np.asarray(T_est, np.float64), np.asarray(T_true, np.float64)
    cos = (np.trace(Te[:3, :3] @ Tt[:3, :3].T) - 1) / 2
    return float(np.arccos(np.clip(cos, -1, 1))), float(np.linalg.norm(Te[:3, 3] - Tt[:3, 3]))
