"""Sharded photometric pose-registration training step. Counterpart of
`gaussiansplattingregistration_tpu/parallel/train_step.py`.

* `data` mesh axis: cameras (targets and view matrices) are split over
  ranks, pure data parallelism over the photometric batch;
* `splat` mesh axis: the N Gaussians. Projection and SH coloring run on
  each rank's shard; the screen records are all-gathered and each rank
  composites its horizontal tile slab ("all_gather"), or they go through
  the depth-sharded compositor ("depth_sharded"); each rank sums the
  squared errors of its slab;
* the pose twist xi and the Adam state are replicated. Each rank
  back-propagates its own slab errors (the gathers' backward sums the
  record cotangents over the splat axis), and the local xi gradients are
  summed once over all ranks: the single-device gradient of the loss. Every
  rank then takes the same Adam step.

On backend "cuda" each rank launches `composite_fwd` and `composite_bwd`
once per camera of its slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gaussiansplattingregistration_tpu_torch.ops import math3d, se3
from gaussiansplattingregistration_tpu_torch.ops.rasterize import (
    RasterizeConfig,
    rasterize_tile_slab,
)
from gaussiansplattingregistration_tpu_torch.parallel import collectives
from gaussiansplattingregistration_tpu_torch.parallel.compositor import (
    bucket_capacity,
    composite_body,
)
from gaussiansplattingregistration_tpu_torch.parallel.mesh import axis_size
from gaussiansplattingregistration_tpu_torch.parallel.sharded_raster import (
    screen_records,
    shard_splats,  # noqa: F401  (this module's name in the JAX package)
    tile_grid,
    unpack_records,
)
from gaussiansplattingregistration_tpu_torch.utils.device import as_tensor, resolve_device


def make_photometric_train_step(
    mesh,
    width: int,
    height: int,
    sh_degree: int,
    config: RasterizeConfig,
    learning_rate: float = 5e-3,
    compositor: str = "all_gather",
    capacity_slack: float = 1.5,
    device=None,
):
    """Build the sharded train step on `device` (default `cuda`); every rank
    of the mesh (which spans the default group) builds and calls it.

    splats: this rank's shard from `shard_splats`, dict(means [n, 3], cov
    [n, 6], opacity [n], features [n, K, 3]); cameras: the whole batch,
    viewmats [C, 4, 4] and intrinsics [C, 3, 3], with C a multiple of the
    data-axis size (each rank takes its slice); targets [C, H_pad, W_pad, 3]
    from `pad_targets`.

    compositor:
      * "all_gather": every rank receives every screen record and
        composites its tile slab: O(N_total) memory per rank;
      * "depth_sharded": records are all-to-all'ed into depth buckets, each
        rank composites its ~N/D-record depth slice over the full grid, then
        tile slabs fold front to back (`parallel/compositor.py`). A bucket
        holds `capacity_slack * N/D` records; records past it are dropped
        and counted in the step's `dropped`: nonzero means the render (and
        its gradients) were truncated and capacity_slack should be raised.

    Loss: the squared error of clip(rgb, 0, 1) against the targets, summed
    over cameras, pixels and channels, over C * H * W * 3. Adam with optax's
    defaults (b1 0.9, b2 0.999, eps 1e-8).

    Returns (step, init, pad_targets). `init(xi0=None) -> (xi, opt_state)`;
    `step(xi, opt_state, splats, viewmats, intrinsics, targets) -> (xi,
    opt_state, loss, dropped)` updates xi in place; after it, `xi.grad`
    holds the step's gradient, summed over ranks. dropped is 0 for
    "all_gather".
    """
    if compositor not in ("all_gather", "depth_sharded"):
        raise ValueError(f"unknown compositor {compositor!r}")
    dev = resolve_device(device)
    ts = config.tile_size
    n_splat, n_data = axis_size(mesh, "splat"), axis_size(mesh, "data")
    splat_group, data_group = mesh.get_group("splat"), mesh.get_group("data")
    tiles_x, tiles_y, tiles_y_padded = tile_grid(width, height, n_splat, config)
    padded_h = tiles_y_padded * ts
    tiles_per_dev = tiles_y_padded // n_splat
    ty_offset = mesh.get_local_rank("splat") * tiles_per_dev
    rows = slice(ty_offset * ts, (ty_offset + tiles_per_dev) * ts)
    # My slab's pixels inside the image: the padding rows and columns count
    # in no error.
    row = torch.arange(rows.start, rows.stop, device=dev)
    col = torch.arange(tiles_x * ts, device=dev)
    mask = ((row[:, None] < height) & (col[None, :] < width)).to(torch.float32)[..., None]

    def camera_error(xi, splats, viewmat, intrinsic, target):
        """This rank's slab error for one camera, and the records dropped."""
        T = se3.se3_exp(xi)
        R = T[:3, :3]
        means = splats["means"] @ R.T + T[:3, 3]
        cov = math3d.transform_covariance(splats["cov"], R)
        if compositor == "all_gather":
            rec = collectives.all_gather(
                screen_records(means, cov, splats["opacity"], splats["features"], viewmat,
                               intrinsic, width, height, sh_degree, config), splat_group)
            rgb, _, _ = rasterize_tile_slab(
                *unpack_records(rec), tiles_x, tiles_y, config, ty_offset=ty_offset,
                tiles_y_window=tiles_per_dev)
            dropped = 0
        else:
            cap = bucket_capacity(means.shape[0], n_splat, capacity_slack)
            rgb, _, _, dropped = composite_body(
                means, cov, splats["opacity"], splats["features"], viewmat, intrinsic,
                torch.zeros(3, device=dev), width, height, sh_degree, tiles_x, tiles_y,
                tiles_y_padded, cap, config, splat_group)
        return torch.sum((torch.clamp(rgb, 0.0, 1.0) - target[rows]) ** 2 * mask), dropped

    def step(xi, opt_state, splats, viewmats, intrinsics, targets):
        n_cams = viewmats.shape[0]
        if n_cams % n_data:
            raise ValueError(f"{n_cams} cameras do not split over data={n_data}")
        per_rank = n_cams // n_data
        first = mesh.get_local_rank("data") * per_rank
        norm = n_cams * height * width * 3.0
        xi.grad = torch.zeros_like(xi)
        err = torch.zeros((), device=dev)
        dropped = torch.zeros((), dtype=torch.int64, device=dev)
        # One camera's graph at a time: its backward runs (and its
        # collectives meet the other ranks') before the next is built.
        for c in range(first, first + per_rank):
            e, d = camera_error(xi, splats, as_tensor(viewmats[c], dev),
                                as_tensor(intrinsics[c], dev), as_tensor(targets[c], dev))
            (e / norm).backward()
            err = err + e.detach()
            dropped = dropped + d
        # The local gradients and errors summed once over all ranks; dropped
        # is already summed over the splat axis.
        total = collectives.all_reduce(torch.cat([xi.grad, err[None]]), "sum")
        with torch.no_grad():
            xi.grad.copy_(total[:6])
        if compositor == "depth_sharded":
            dropped = collectives.all_reduce(dropped, "sum", data_group)
        opt_state.step()
        return xi, opt_state, total[6] / norm, dropped

    def init(xi0=None):
        xi = torch.zeros(6, device=dev) if xi0 is None else as_tensor(xi0, dev).clone()
        xi.requires_grad_(True)
        return xi, torch.optim.Adam([xi], lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)

    def pad_targets(targets):
        """[C, H, W, 3] -> [C, padded_h, tiles_x * ts, 3], zeros outside."""
        targets = as_tensor(targets, dev)
        return F.pad(targets, (0, 0, 0, tiles_x * ts - targets.shape[2],
                               0, padded_h - targets.shape[1]))

    return step, init, pad_targets
