"""Multi-GPU rasterization: splat-sharded projection, tile-sharded
compositing. Counterpart of
`gaussiansplattingregistration_tpu/parallel/sharded_raster.py`.

* each rank holds N/D splats and projects them locally (the per-splat EWA
  math never crosses ranks);
* the compact screen records (means2d, conic, depth, radius, valid, color,
  opacity: 12 floats a splat, packed into one tensor) are all-gathered over
  the `splat` axis;
* image tiles are range-partitioned over the same axis: each rank bins and
  composites only its horizontal tile slab (`rasterize_tile_slab`), so the
  sort and the K-deep compositing shrink by 1/D per rank; on backend "cuda"
  that is one `composite_fwd` launch per rank and frame (one
  `composite_bwd` under autograd), `max_live_tiles` capping each slab.
  Tile rows are padded to a multiple of D, but splats are binned against
  the image's own tile rows, and each slab's sort key keeps the depth bits
  of the whole image's: a slab's tiles hold the entries, in
  the order and truncated at K, that they hold on one device. The JAX
  package bins against the padded rows (which moves the clipped tile
  window of a splat reaching below the image) and keys each slab by its
  own tile count (which reorders near-equal depths, and where K binds
  keeps other entries);
* the slabs are all-gathered and cropped, so every rank returns the full
  image, as the JAX package's replicated output.

Gradients flow through the gathers (`collectives.all_gather`); with a loss
taken on every rank from the replicated image, each rank's splats get the
single-device gradient (`collectives.replicated_output`).

The all-gather keeps per-rank memory and sort cost O(N_total); the
scalable design is `parallel/compositor.py`.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from gaussiansplattingregistration_tpu_torch.ops.rasterize import (
    DEFAULT_CONFIG,
    RasterizeConfig,
    compute_view_colors,
    project_gaussians,
    rasterize_tile_slab,
)
from gaussiansplattingregistration_tpu_torch.parallel import collectives
from gaussiansplattingregistration_tpu_torch.parallel.mesh import axis_size, pad_to_multiple
from gaussiansplattingregistration_tpu_torch.utils.device import as_tensor, resolve_device


def screen_records(means, cov3d, opacity, features, viewmat, intrinsics,
                   width: int, height: int, sh_degree: int,
                   config: RasterizeConfig) -> torch.Tensor:
    """Project local splats into screen records [n, 12]: means2d 2 | conic
    3 | depth 1 | radius 1 | valid 1 | color 3 | opacity 1 (zero where not
    valid)."""
    proj = project_gaussians(means, cov3d, viewmat, intrinsics, width, height, config)
    cam_center = -(viewmat[:3, :3].T @ viewmat[:3, 3])
    colors = compute_view_colors(features, means, cam_center, sh_degree)
    valid = proj["valid"].to(opacity.dtype)
    return torch.cat([proj["means2d"], proj["conic"], proj["depth"][:, None],
                      proj["radius"][:, None], valid[:, None], colors,
                      (opacity * valid)[:, None]], dim=-1)


def unpack_records(rec: torch.Tensor) -> tuple:
    """`rasterize_tile_slab`'s first seven arguments from records [n, 12]."""
    return (rec[:, 0:2], rec[:, 2:5], rec[:, 5], rec[:, 6], rec[:, 7] > 0.5,
            rec[:, 8:11], rec[:, 11])


def gather_slabs(rgb, alpha, depth, width: int, height: int, group):
    """Every rank's (rgb, alpha, depth) slab, stacked along H in group-rank
    order and cropped: the full image, replicated."""
    slab = torch.cat([rgb, alpha[..., None], depth[..., None]], dim=-1)
    img = collectives.replicated_output(collectives.all_gather(slab, group), group)
    img = img[:height, :width]
    return img[..., 0:3], img[..., 3], img[..., 4]


def tile_grid(width: int, height: int, n_dev: int, config: RasterizeConfig):
    """(tiles_x, tiles_y, tiles_y_padded): the image's tile grid and its
    rows rounded up to a multiple of the splat-axis size; tiles past the
    image get no splat and are cropped."""
    ts = config.tile_size
    tiles_y = -(-height // ts)
    return -(-width // ts), tiles_y, pad_to_multiple(tiles_y, n_dev)


def shard_splats(cloud, mesh, scaling_modifier: float = 1.0, device=None) -> dict:
    """This rank's splat shard of a cloud every rank holds: the cloud padded
    with zero-opacity splats to a multiple of the splat-axis size, rows
    [r * N/D, (r + 1) * N/D) for splat rank r, as raw arrays on `device`."""
    dev = resolve_device(device)
    n_dev, r = axis_size(mesh, "splat"), mesh.get_local_rank("splat")
    padded = cloud.pad_to(pad_to_multiple(cloud.num_points, n_dev))
    m = padded.num_points // n_dev
    rows = slice(r * m, (r + 1) * m)
    return {
        "means": padded.xyz[rows].to(dev),
        "cov": padded.get_covariance(scaling_modifier)[rows].to(dev),
        "opacity": padded.get_opacity[rows, 0].to(dev),
        "features": padded.get_features[rows].to(dev),
    }


def rasterize_arrays_sharded(
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
    device=None,
):
    """Multi-rank rasterization over a mesh axis, called by every rank with
    its own splat shard (pad the cloud with `GaussianCloud.pad_to`);
    returns the full (rgb, alpha, depth) on every rank."""
    dev = resolve_device(device)
    means, cov3d, opacity, features, viewmat, intrinsics, background = (
        as_tensor(a, dev) for a in
        (means, cov3d, opacity, features, viewmat, intrinsics, background))
    group = mesh.get_group(axis)
    n_dev, my = dist.get_world_size(group), dist.get_rank(group)
    tiles_x, tiles_y, tiles_y_padded = tile_grid(width, height, n_dev, config)
    tiles_per_dev = tiles_y_padded // n_dev

    rec = collectives.all_gather(
        screen_records(means, cov3d, opacity, features, viewmat, intrinsics,
                       width, height, sh_degree, config), group)
    rgb, alpha, depth = rasterize_tile_slab(
        *unpack_records(rec), tiles_x, tiles_y, config,
        ty_offset=my * tiles_per_dev, tiles_y_window=tiles_per_dev,
    )
    rgb = rgb + (1.0 - alpha[..., None]) * background[None, None, :]
    return gather_slabs(rgb, alpha, depth, width, height, group)


def rasterize_sharded(
    cloud,
    camera,
    mesh,
    background=(0.0, 0.0, 0.0),
    scaling_modifier: float = 1.0,
    config: RasterizeConfig = DEFAULT_CONFIG,
    device=None,
):
    """Render a GaussianCloud, held by every rank, over the mesh's splat
    axis, on `device` (default `cuda`)."""
    s = shard_splats(cloud, mesh, scaling_modifier, device)
    return rasterize_arrays_sharded(
        s["means"], s["cov"], s["opacity"], s["features"],
        camera.viewmat, camera.intrinsics, camera.width, camera.height,
        cloud.sh_degree, background, config, mesh=mesh, device=device,
    )
