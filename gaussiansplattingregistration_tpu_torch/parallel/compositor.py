"""Scalable multi-GPU compositor: depth-sharded partial composites.
Counterpart of `gaussiansplattingregistration_tpu/parallel/compositor.py`.

`parallel/sharded_raster.py` gathers every screen record to every rank, so
per-rank memory and sort stay O(N_total). Here, the ring-attention analogue
for alpha compositing:

1. each rank projects its N/D splats locally (12-float records);
2. ranks agree on D-1 global depth pivots (quantiles of a histogram summed
   over ranks) and `all_to_all` the records into depth buckets: rank d owns
   the d-th front-to-back slice of the scene (~N/D records, a fixed
   capacity per bucket with an overflow counter);
3. each rank bins, sorts and composites its depth slice over the full tile
   grid (on backend "cuda" one `composite_fwd` launch), producing per-pixel
   partials (rgb, acc_alpha = 1 - T, depth);
4. one more `all_to_all` moves tile slabs: rank j receives the j-th slab of
   every rank's partial, ordered by source = depth order, and folds them
   with the associative over-operator
       (rgb_a, T_a) (+) (rgb_b, T_b) = (rgb_a + T_a * rgb_b, T_a * T_b).

Per-rank memory: O(N/D) records + O(tiles * pixels) partials.

EXACTNESS. Depth bucketing keeps the global front-to-back order, so with
`transmittance_min = 0` the result equals the single-device render to f32
rounding. With early termination on (default 1e-4) a bucket cannot see the
transmittance flowing in from nearer buckets, so entries the single-device
pass zeroes (T <= tmin) survive scaled by T_in <= tmin: the per-pixel
deviation is bounded by transmittance_min (tests/test_torch_compositor.py).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from gaussiansplattingregistration_tpu_torch.ops.rasterize import (
    DEFAULT_CONFIG,
    RasterizeConfig,
    rasterize_tile_slab,
)
from gaussiansplattingregistration_tpu_torch.parallel import collectives
from gaussiansplattingregistration_tpu_torch.parallel.sharded_raster import (
    gather_slabs,
    screen_records,
    shard_splats,
    tile_grid,
    unpack_records,
)
from gaussiansplattingregistration_tpu_torch.utils.device import as_tensor, resolve_device

_HIST_BINS = 256


def bucket_capacity(n_local: int, n_dev: int, capacity_slack: float) -> int:
    """Records each rank may send to each depth bucket."""
    return max(128, -(-int(n_local * capacity_slack) // n_dev // 128) * 128)


def _depth_pivots(depth, valid, n_dev: int, group, config: RasterizeConfig):
    """Global depth-quantile pivots [n_dev - 1] from a histogram summed over
    the group. Bucketing is a routing decision: no gradient flows through
    it, so the depth is detached."""
    depth = depth.detach()
    zmax = collectives.all_reduce(
        torch.max(torch.where(valid, depth, config.near)), "max", group)
    zmin = config.near
    span = torch.clamp_min(zmax - zmin, 1e-6)
    b = torch.clamp(((depth - zmin) / span * _HIST_BINS).to(torch.int32), 0, _HIST_BINS - 1)
    hist = torch.zeros(_HIST_BINS, dtype=torch.int64, device=depth.device)
    hist.index_add_(0, b.long(), valid.long())
    cum = torch.cumsum(collectives.all_reduce(hist, "sum", group), dim=0)
    total = torch.clamp_min(cum[-1], 1)
    # pivot_j = upper edge of the first bin where cum >= j/D * total
    targets = (torch.arange(1, n_dev, device=depth.device) * total) // n_dev
    bins = torch.searchsorted(cum, targets, right=False)
    return zmin + (bins.to(torch.float32) + 1.0) / _HIST_BINS * span


def _exchange_records(rec, bucket, n_dev: int, cap: int, group):
    """all_to_all records into depth buckets.

    rec [n_local, F], bucket [n_local] in [0, n_dev] (n_dev: culled, never
    sent) -> ([n_dev * cap, F] records of this rank's depth slice, the
    count of records past a bucket's capacity, summed over the group)."""
    order = torch.argsort(bucket, stable=True)      # ties keep local order
    rec_s = rec[order]
    b_s = bucket[order]
    ids = torch.arange(n_dev, device=rec.device, dtype=b_s.dtype)
    starts = torch.searchsorted(b_s, ids)
    counts = torch.searchsorted(b_s, ids, right=True) - starts
    rec_p = F.pad(rec_s, (0, 0, 0, cap))
    k = torch.arange(cap, device=rec.device)
    live = (k[None, :] < counts[:, None])[..., None]                  # [n_dev, cap, 1]
    send = torch.where(live, rec_p[starts[:, None] + k[None, :]], 0.0)
    dropped = collectives.all_reduce(torch.sum(torch.clamp_min(counts - cap, 0)), "sum", group)
    return collectives.all_to_all(send.reshape(n_dev * cap, rec.shape[1]), group), dropped


def composite_body(
    means, cov3d, opacity, features,
    viewmat, intrinsics, background,
    width: int, height: int, sh_degree: int,
    tiles_x: int, tiles_y: int, tiles_y_padded: int, cap: int,
    config: RasterizeConfig, group,
):
    """Per-rank body: returns this rank's final tile slab (rgb
    [slab_h, W_pad, 3], alpha, depth) and the group's dropped count. Splats
    are binned against the image's tiles_y rows (`sharded_raster`)."""
    n_dev = dist.get_world_size(group)

    # 1. local projection -> compact records
    rec = screen_records(means, cov3d, opacity, features, viewmat, intrinsics,
                         width, height, sh_degree, config)
    depth, valid = rec[:, 5], rec[:, 7] > 0.5

    # 2. depth pivots + record exchange (rank d <- depth slice d). Culled
    # records get bucket n_dev: they sort past every real bucket run and are
    # never sent, so they cannot crowd out real ones.
    pivots = _depth_pivots(depth, valid, n_dev, group, config)
    bucket = torch.searchsorted(pivots, depth.detach().contiguous(), right=True)
    bucket = torch.where(valid, bucket, n_dev)
    rec2, dropped = _exchange_records(rec, bucket, n_dev, cap, group)

    # 3. composite my depth slice over the full tile grid
    rgb_p, alpha_p, depth_p = rasterize_tile_slab(
        *unpack_records(rec2), tiles_x, tiles_y, config, tiles_y_window=tiles_y_padded)
    partial = torch.cat([rgb_p, alpha_p[..., None], depth_p[..., None]], dim=-1)

    # 4. slab exchange: rank j gets slab j of every depth slice; sources
    # arrive in depth order -> front-to-back fold.
    slab_h = tiles_y_padded // n_dev * config.tile_size
    parts = collectives.all_to_all(partial, group).reshape(
        n_dev, slab_h, partial.shape[1], 5)
    rgb = torch.zeros_like(parts[0, ..., 0:3])
    T = torch.ones_like(parts[0, ..., 0])
    dep = torch.zeros_like(parts[0, ..., 0])
    for p in parts:
        rgb = rgb + T[..., None] * p[..., 0:3]
        dep = dep + T * p[..., 4]
        T = T * (1.0 - p[..., 3])
    rgb = rgb + T[..., None] * background[None, None, :]
    return rgb, 1.0 - T, dep, dropped


def rasterize_arrays_depth_sharded(
    means,        # [N/D, 3] this rank's shard
    cov3d,        # [N/D, 6]
    opacity,      # [N/D]
    features,     # [N/D, K, 3]
    viewmat,
    intrinsics,
    width: int,
    height: int,
    sh_degree: int,
    background,
    config: RasterizeConfig = DEFAULT_CONFIG,
    *,
    mesh,
    axis: str = "splat",
    capacity_slack: float = 1.5,
    device=None,
):
    """Depth-sharded multi-rank rasterization (module docstring), called by
    every rank with its own shard.

    Returns (rgb [H,W,3], alpha [H,W], depth [H,W], dropped) on every rank;
    `dropped` is the total record count that overflowed the per-bucket
    capacity (0: the fixed capacity was exact for this scene and view)."""
    dev = resolve_device(device)
    means, cov3d, opacity, features, viewmat, intrinsics, background = (
        as_tensor(a, dev) for a in
        (means, cov3d, opacity, features, viewmat, intrinsics, background))
    group = mesh.get_group(axis)
    n_dev = dist.get_world_size(group)
    grid = tile_grid(width, height, n_dev, config)
    cap = bucket_capacity(means.shape[0], n_dev, capacity_slack)
    rgb, alpha, depth, dropped = composite_body(
        means, cov3d, opacity, features, viewmat, intrinsics, background,
        width, height, sh_degree, *grid, cap, config, group)
    return gather_slabs(rgb, alpha, depth, width, height, group) + (dropped,)


def rasterize_depth_sharded(
    cloud,
    camera,
    mesh,
    background=(0.0, 0.0, 0.0),
    scaling_modifier: float = 1.0,
    config: RasterizeConfig = DEFAULT_CONFIG,
    capacity_slack: float = 1.5,
    device=None,
):
    """Render a GaussianCloud, held by every rank, with the depth-sharded
    compositor, on `device` (default `cuda`)."""
    s = shard_splats(cloud, mesh, scaling_modifier, device)
    return rasterize_arrays_depth_sharded(
        s["means"], s["cov"], s["opacity"], s["features"],
        camera.viewmat, camera.intrinsics, camera.width, camera.height,
        cloud.sh_degree, background, config, mesh=mesh,
        capacity_slack=capacity_slack, device=device,
    )
