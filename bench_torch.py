"""Benchmarks for the five BASELINE.json configs on the PyTorch/CUDA port.

The counterpart of bench.py, with its metric names, units and detail keys.
ONE JSON line on stdout: the headline metric (rasterize fwd+bwd pixels/s at
1M splats, 1280x720). The other four configs (ICP iters/s, FPFH + RANSAC +
colored-refine wall, HEM + multiscale wall, photometric pose-opt steps/s)
are printed as JSON lines on stderr, and written to a file only where
`--extra-out PATH` names one.

    python3 bench_torch.py                     # on the card
    python3 bench_torch.py --headline-only     # the headline alone
    python3 bench_torch.py --extra-out PATH    # also write the secondaries
    python3 bench_torch.py --device cpu        # the CPU (tests, small sizes)

Runs on `cuda` unless `--device cpu` is given, and raises without a card.
The headline is published only when the work it times is the real work:
no tile's gradients cut by the backward cap, no live tile past
`max_live_tiles`, and the truncated render at least 40 dB against a
C=8 / K-exact render of the plain path (`backend="torch"`) over three
poses. On the card, each timed frame must launch each composite kernel
once. The sizes are the module constants below (bench.py's); the tests
set them smaller.

`vs_baseline`: the reference publishes no numbers, so the headline's
denominator is an estimate of gsplat's fwd+bwd throughput on an H100
(bench.py's). The secondaries have no reference numbers; vs_baseline is
null there.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import traceback

import numpy as np
import torch

from gaussiansplattingregistration_tpu_torch.models import parameters as P
from gaussiansplattingregistration_tpu_torch.models.camera import Camera
from gaussiansplattingregistration_tpu_torch.ops import global_registration as gr
from gaussiansplattingregistration_tpu_torch.ops import hem as hem_ops
from gaussiansplattingregistration_tpu_torch.ops import icp as icp_ops
from gaussiansplattingregistration_tpu_torch.ops import math3d, raster_cuda
from gaussiansplattingregistration_tpu_torch.ops.rasterize import (
    RasterizeConfig,
    rasterize_arrays,
    rasterize_arrays_with_stats,
    tile_bin,
)
from gaussiansplattingregistration_tpu_torch.pipelines import photometric
from gaussiansplattingregistration_tpu_torch.pipelines.multiscale import (
    multiscale_mixture_registration,
)
from gaussiansplattingregistration_tpu_torch.utils.device import resolve_device
from port_scenes import (
    card_line,
    clustered_draws,
    global_draws,
    hem_cloud,
    icp_draws,
    photometric_camera,
    photometric_cloud,
    photometric_config,
    point_cloud,
    splat_arrays,
    uniform_draws,
)

# An estimate of gsplat's fwd+bwd throughput on an H100 at 1M splats, not a
# measurement (bench.py's denominator).
H100_FWD_BWD_PIXELS_PER_S = 2.5e8

# Headline (config 4): splats, image, warm-up and timed frames.
WIDTH, HEIGHT = 1280, 720
N_SPLATS = 1_000_000
WARMUP = 3
ITERS = 32
# Config 1 (ICP), config 2 (global), config 3 (HEM), config 5 (photometric).
ICP_POINTS = 100_000
GLOBAL_POINTS = 50_000
HEM_SPLATS = 200_000
PHOTO_SPLATS = 100_000
PHOTO_WIDTH, PHOTO_HEIGHT = 640, 360
# The truncation oracle's poses (yaw about y) and its gate.
ORACLE_YAWS = (0.0, 0.35, -0.35)
ORACLE_MIN_DB = 40.0


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launches():
    return {"composite_fwd": raster_cuda.composite_tiles.launches,
            "composite_bwd": raster_cuda.composite_tiles_bwd.launches,
            "tile_bin": tile_bin.launches}


def _reset_launches():
    raster_cuda.composite_tiles.launches = 0
    raster_cuda.composite_tiles_bwd.launches = 0
    tile_bin.launches = 0


# --------------------------------------------------------- the headline

def headline_config():
    """bench.py's accelerator-branch config (bench.py:74-101) on "cuda":
    C=4 (tiny splats: a 2x2 tile window is exact), K=384 (held >= 40 dB by
    the truncation oracle at every run), no backward cap (the scene is
    deep), bf16 cotangent transport, and a cap of 2688 processed tile rows
    (the scene leaves ~28% of its 3600 tiles empty at every oracle pose;
    `live_tile_overflow` counts a live tile past it)."""
    return RasterizeConfig(max_tiles_per_splat=4, max_splats_per_tile=384, tile_chunk=32,
                           max_bwd_splats_per_tile=None, bwd_sort_bf16=True,
                           max_live_tiles=2688, backend="cuda")


def focal():
    return WIDTH / (2 * math.tan(math.radians(70) / 2))


def orbit_viewmats(dev):
    """The oracle's camera poses: yaw 0 and +-0.35 about y from (0, 0, 3)."""
    f, out = focal(), []
    for yaw in ORACLE_YAWS:
        R = math3d.axis_angle_to_rotmat(torch.tensor([0.0, 1.0, 0.0]), torch.tensor(yaw))
        out.append(Camera.create(R, [0.0, 0.0, 3.0], f, f, WIDTH, HEIGHT, device=dev).viewmat)
    return out


def truncation_oracle(arrays, viewmats, intrinsics, width, height, config, label,
                      render_cfg=None):
    """Each pose's PSNR of `render_cfg` (default `config`) against the
    untruncated render: the plain path at C=8, tile_chunk 4 and K = K_exact,
    the longest pre-truncation tile run over the poses (probed at C=8)
    rounded up to 128, with no backward cap. Returns (per-view PSNR in dB,
    K_exact, max_run)."""
    render_cfg = render_cfg or config
    dev = arrays[0].device
    bg = torch.zeros(3, device=dev)
    probe_cfg = dataclasses.replace(config, backend="torch", max_tiles_per_splat=8,
                                    tile_chunk=4)
    max_run = 0
    for vm in viewmats:
        stats = rasterize_arrays_with_stats(*arrays, vm, intrinsics, width, height, 0, bg,
                                            probe_cfg, device=dev)[3]
        max_run = max(max_run, int(stats["max_run"]))
    k_exact = -(-max_run // 128) * 128
    oracle_cfg = dataclasses.replace(config, backend="torch", max_tiles_per_splat=8,
                                     max_splats_per_tile=k_exact, tile_chunk=4,
                                     max_bwd_splats_per_tile=None)
    per_view = []
    for yaw, vm in zip(ORACLE_YAWS, viewmats):
        t0 = time.perf_counter()
        rgb_t = rasterize_arrays(*arrays, vm, intrinsics, width, height, 0, bg, render_cfg,
                                 device=dev)[0]
        rgb_e = rasterize_arrays(*arrays, vm, intrinsics, width, height, 0, bg, oracle_cfg,
                                 device=dev)[0]
        mse = float(torch.mean((rgb_t - rgb_e) ** 2))
        psnr = 10.0 * math.log10(1.0 / max(mse, 1e-12))
        per_view.append(psnr)
        _log(f"# truncation oracle [{label}]: yaw={yaw:+.2f} "
             f"K_exact={k_exact} psnr_vs_exact={psnr:.2f} dB "
             f"({time.perf_counter() - t0:.2f} s for both renders)")
    return per_view, k_exact, max_run


def check_stats(stats):
    """The headline frame drops no gradient and no live tile."""
    viol = int(stats["bwd_cap_violations"])
    if viol:
        raise RuntimeError(f"bench config drops gradients ({viol} tiles over the bwd cap)")
    lto = int(stats.get("live_tile_overflow", 0))
    if lto:
        raise RuntimeError(
            f"bench config drops {lto} live tiles (max_live_tiles too "
            "small for this scene/view)"
        )


def check_truncation(min_psnr, k_exact):
    if min_psnr < ORACLE_MIN_DB:
        raise RuntimeError(
            f"headline scene truncation is visible: min {min_psnr:.1f} "
            f"dB < {ORACLE_MIN_DB:g} dB vs the C=8/K={k_exact} exact render over "
            f"{len(ORACLE_YAWS)} poses; raise max_splats_per_tile or "
            f"max_tiles_per_splat"
        )


def bench_raster(dev):
    """Config 4: 1M-splat tile rasterization, fwd+bwd (the headline)."""
    config = headline_config()
    arrays = splat_arrays(uniform_draws(N_SPLATS), dev)
    f = focal()
    cam = Camera.create(np.eye(3), [0.0, 0.0, 3.0], f, f, WIDTH, HEIGHT, device=dev)
    viewmat, intr = cam.viewmat, cam.intrinsics
    bg = torch.zeros(3, device=dev)

    # The gates, before any timing: the stats of the timed pose, then the
    # truncation oracle on the uniform scene (enforced) and on the clustered
    # one (reported; max_live_tiles is this scene's tuning, so the clustered
    # render runs with the cap off).
    stats = rasterize_arrays_with_stats(*arrays, viewmat, intr, WIDTH, HEIGHT, 0, bg,
                                        config, device=dev)[3]
    stats = {k: float(v) for k, v in stats.items()}
    _log(f"# raster stats: {json.dumps(stats)}")
    check_stats(stats)
    viewmats = orbit_viewmats(dev)
    per_view, k_exact, _ = truncation_oracle(arrays, viewmats, intr, WIDTH, HEIGHT, config,
                                             "uniform")
    per_view = [round(p, 2) for p in per_view]
    check_truncation(min(per_view), k_exact)
    clustered = splat_arrays(clustered_draws(N_SPLATS), dev)
    cl_per_view, cl_k, _ = truncation_oracle(
        clustered, viewmats, intr, WIDTH, HEIGHT, config, "clustered",
        render_cfg=dataclasses.replace(config, max_live_tiles=None))
    del clustered
    cl_per_view = [round(p, 2) for p in cl_per_view]

    params = [a.detach().clone().requires_grad_(True) for a in arrays]

    def fwd_bwd():
        rgb = rasterize_arrays(*params, viewmat, intr, WIDTH, HEIGHT, 0, bg, config,
                               device=dev)[0]
        return torch.autograd.grad(rgb.sum(), params)

    for _ in range(WARMUP):
        fwd_bwd()
    _sync(dev)
    _reset_launches()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        fwd_bwd()
    _sync(dev)
    dt = (time.perf_counter() - t0) / ITERS
    launches = _launches()
    if dev.type == "cuda" and launches != {"composite_fwd": ITERS, "composite_bwd": ITERS,
                                           "tile_bin": ITERS}:
        raise RuntimeError(f"the timed frames launched {launches}, not {ITERS} of each kernel")

    pixels_per_s = WIDTH * HEIGHT / dt
    return {
        "metric": "rasterize_fwd_bwd_pixels_per_s_per_chip_1M_splats",
        "value": round(pixels_per_s, 1),
        "unit": "pixels/s/chip",
        "vs_baseline": round(pixels_per_s / H100_FWD_BWD_PIXELS_PER_S, 4),
        "detail": {**stats,
                   "truncation_psnr_db": min(per_view),
                   "truncation_psnr_per_view_db": per_view,
                   "truncation_psnr_clustered_db": min(cl_per_view),
                   "truncation_psnr_clustered_per_view_db": cl_per_view,
                   "clustered_k_exact": cl_k,
                   "card": card_line(dev),
                   "launches": launches},
    }


# ---------------------------------------------------------- secondaries

def bench_icp(dev):
    """Config 1: point-to-point ICP iterations/s on two 100k-point clouds
    (correspondence "auto"), and the volumetric 100k pair at a tight gate."""
    src, tgt, _, vol_src, vol, _ = icp_draws(ICP_POINTS)
    src, tgt = point_cloud(src, dev=dev), point_cloud(tgt, dev=dev)
    params = P.LocalRegistrationParams(
        max_correspondence=0.3, max_iteration=30,
        relative_fitness=0.0, relative_rmse=0.0,  # run all 30 iters
    )
    res = icp_ops.icp(src, tgt, params)  # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    runs = 3
    for _ in range(runs):
        res = icp_ops.icp(src, tgt, params)
    _sync(dev)
    dt = (time.perf_counter() - t0) / runs

    # A volumetric cloud at a tight gate: the regime of the grid-pruned
    # correspondence path.
    src_v, tgt_v = point_cloud(vol_src, dev=dev), point_cloud(vol, dev=dev)
    params_v = P.LocalRegistrationParams(
        max_correspondence=0.05, max_iteration=30,
        relative_fitness=0.0, relative_rmse=0.0,
    )
    icp_ops.icp(src_v, tgt_v, params_v)
    _sync(dev)
    t0 = time.perf_counter()
    res_v = icp_ops.icp(src_v, tgt_v, params_v)
    _sync(dev)
    dt_v = time.perf_counter() - t0

    return {
        "metric": "icp_p2p_iters_per_s_100k_pts",
        "value": round(res.num_iterations / dt, 2),
        "unit": "iters/s",
        "vs_baseline": None,
        "detail": {"fitness": res.fitness, "rmse": res.inlier_rmse,
                   "iters": res.num_iterations, "wall_s": round(dt, 4),
                   "volumetric_grid_iters_per_s": round(res_v.num_iterations / dt_v, 2),
                   "volumetric_fitness": res_v.fitness},
    }


def bench_global(dev):
    """Config 2: FPFH+RANSAC global then colored-ICP refine (wall-clock)."""
    src, tgt, col, _ = global_draws(GLOBAL_POINTS)
    src, tgt = point_cloud(src, col, dev), point_cloud(tgt, col, dev)
    ransac = P.RANSACRegistrationParams(
        voxel_size=0.05,
        checkers=(P.CorrespondenceChecker("edge_length", 0.9),
                  P.CorrespondenceChecker("distance", 0.075)),
        max_iteration=100_000, confidence=0.999,
    )
    refine = P.LocalRegistrationParams(
        registration_type=P.LocalRegistrationType.ICP_COLOR,
        max_correspondence=0.1, max_iteration=30,
    )
    # A warm-up pass at seed 0, then the timed pass at seed 1.
    g = gr.ransac_registration(src, tgt, ransac, seed=0)
    icp_ops.icp(src, tgt, refine, init_transform=g.transformation)
    _sync(dev)
    t0 = time.perf_counter()
    g = gr.ransac_registration(src, tgt, ransac, seed=1)
    r = icp_ops.icp(src, tgt, refine, init_transform=g.transformation)
    _sync(dev)
    dt = time.perf_counter() - t0

    # Hypothesis throughput apart from the wall: confidence=1.0 runs the
    # search until a hypothesis scores fitness 1.0 or all 16384 ran.
    flood = dataclasses.replace(ransac, max_iteration=16384, confidence=1.0)
    gr.ransac_registration(src, tgt, flood, seed=0)
    _sync(dev)
    t1 = time.perf_counter()
    gf = gr.ransac_registration(src, tgt, flood, seed=1)
    _sync(dev)
    hyp_s = gf.num_iterations / (time.perf_counter() - t1)
    return {
        "metric": "global_fpfh_ransac_plus_colored_refine_wall_s_50k_pts",
        "value": round(dt, 3),
        "unit": "s",
        "vs_baseline": None,
        "detail": {"ransac_fitness": g.fitness, "refine_fitness": r.fitness,
                   "ransac_hypotheses": g.num_iterations,
                   "ransac_hypotheses_per_s": round(hyp_s, 1)},
    }


def bench_hem_multiscale(dev):
    """Config 3: HEM downsample (3 levels) + coarse-to-fine registration.
    `hem_cold_s` is the first run (no compile in the port: the allocator
    and the first launches)."""
    n = HEM_SPLATS
    cloud = hem_cloud(n, dev)
    params = P.GaussianMixtureParams(cluster_level=3)

    t0 = time.perf_counter()
    hem_ops.create_mixture(cloud, params, seed=0, backend="torch", with_stats=True)
    t_hem_cold = time.perf_counter() - t0
    _sync(dev)
    t0 = time.perf_counter()
    levels, hem_stats = hem_ops.create_mixture(cloud, params, seed=0, backend="torch",
                                               with_stats=True)
    t_hem = time.perf_counter() - t0
    _log(f"# hem cold (first) pass: {t_hem_cold:.2f}s")

    level_sizes = [int(lvl.xyz.shape[0]) for lvl in levels]
    # The stats before any gate can raise: a red run still shows why.
    _log(f"# hem levels: sizes={level_sizes} stats={hem_stats}")
    # Each level must cut by >= 1.8x (of the ~3x target).
    prev = n
    for sz in level_sizes:
        if sz > prev / 1.8:
            raise RuntimeError(
                f"HEM bench scene is not clustering: sizes {level_sizes} "
                f"stats {hem_stats}"
            )
        prev = sz

    # The level pyramid (finest -> coarsest) for both clouds; the source
    # copy offset by a known transform.
    tgt_levels = [point_cloud(cloud.xyz, cloud.get_colors, dev)] + [
        point_cloud(lvl.xyz, lvl.colors, dev) for lvl in levels]
    T_off = np.eye(4, dtype=np.float32)
    T_off[:3, 3] = (0.05, -0.03, 0.02)
    src_levels = [pc.transform(T_off) for pc in tgt_levels]
    ms = P.MultiScaleRegistrationParams(voxel_values=[0.3, 0.15, 0.08],
                                        iter_values=[30, 20, 14])
    multiscale_mixture_registration(src_levels, tgt_levels, ms)
    _sync(dev)
    t0 = time.perf_counter()
    res = multiscale_mixture_registration(src_levels, tgt_levels, ms)
    _sync(dev)
    t_reg = time.perf_counter() - t0
    return {
        "metric": "hem3_plus_multiscale_wall_s_200k_splats",
        "value": round(t_hem + t_reg, 3),
        "unit": "s",
        "vs_baseline": None,
        "detail": {"hem_s": round(t_hem, 3),
                   "hem_cold_s": round(t_hem_cold, 3),
                   "multiscale_s": round(t_reg, 3),
                   "level_sizes": level_sizes,
                   "hem_stats": hem_stats,
                   "fitness": res.fitness},
    }


def bench_photometric(dev):
    """Config 5: differentiable photometric pose-opt steps/s, one camera
    (the sharded variant is parallel/train_step.py)."""
    cloud = photometric_cloud(PHOTO_SPLATS, dev)
    cams = [photometric_camera(dev, width=PHOTO_WIDTH, height=PHOTO_HEIGHT)]
    config = photometric_config()
    targets = photometric.render_targets(cloud, cams, config=config, device=dev)

    steps = 10
    photometric.photometric_pose_opt(cloud, cams, targets, steps=2, config=config,
                                     ssim_weight=0.2, device=dev)
    _sync(dev)
    _reset_launches()
    t0 = time.perf_counter()
    res = photometric.photometric_pose_opt(cloud, cams, targets, steps=steps, config=config,
                                           ssim_weight=0.2, device=dev)
    _sync(dev)
    dt = time.perf_counter() - t0
    launches = _launches()
    if dev.type == "cuda" and launches != {"composite_fwd": steps, "composite_bwd": steps,
                                           "tile_bin": steps}:
        raise RuntimeError(f"the timed steps launched {launches}, not {steps} of each kernel")
    return {
        "metric": "photometric_pose_opt_steps_per_s_100k_splats_640x360",
        "value": round(steps / dt, 3),
        "unit": "steps/s",
        "vs_baseline": None,
        "detail": {"final_loss": res.final_loss, "launches": launches},
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--headline-only", action="store_true",
                        help="run the headline alone")
    parser.add_argument("--extra-out", metavar="PATH",
                        help="write the headline and the secondaries to PATH as JSON")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu; without a card, cuda raises")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    t0 = time.perf_counter()
    headline = bench_raster(dev)
    _log(f"# bench_raster: {time.perf_counter() - t0:.1f}s")
    extras = []
    if not args.headline_only:
        for fn in (bench_icp, bench_global, bench_hem_multiscale, bench_photometric):
            try:
                t0 = time.perf_counter()
                r = fn(dev)
                _log(f"# {fn.__name__}: {time.perf_counter() - t0:.1f}s")
                extras.append(r)
            except Exception as e:  # a secondary's failure must not kill the headline
                traceback.print_exc()
                extras.append({"metric": fn.__name__, "error": repr(e)})
            _log(json.dumps(extras[-1]))
    if args.extra_out:
        with open(args.extra_out, "w") as fh:
            json.dump({"headline": headline, "secondary": extras}, fh, indent=1)

    # The one stdout JSON line.
    print(json.dumps(headline), flush=True)


if __name__ == "__main__":
    main()
