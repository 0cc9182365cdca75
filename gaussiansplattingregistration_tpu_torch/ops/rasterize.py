"""Differentiable tile-based 3DGS rasterizer (torch + the CUDA compositor).

Torch counterpart of `gaussiansplattingregistration_tpu/ops/rasterize.py`:
explicit 3D covariances, RGB render mode, SH view-dependent color,
background blending, `radius_clip=3` culling. Pipeline:

1. projection: EWA splatting Σ2D = J W Σ Wᵀ Jᵀ (+0.3 px low-pass as 3DGS);
2. tile binning: each splat emits up to `max_tiles_per_splat` (tile, depth)
   entries (bounded coverage, the centred C-window clip);
3. ONE stable sort over a fused (tile id | quantized depth) key in entry-id
   order, so near-equal depths keep entry-id order exactly as the JAX
   package's two-key sort does; the front-most K entries of each tile run
   form the [tiles, K] table, integer-for-integer the JAX package's. On
   CUDA tensors steps 2-3 are the kernels of `csrc/tile_bin.cu`
   (`tile_bin`), which emit and sort only the slots that hold a tile, as
   32-bit keys; on CPU tensors the plain form keys every [N, C] slot;
4. one gather pulls per-entry params into the channel-major [T, 10, K]
   layout (`gather_entries`);
5. compositing: backend "cuda" runs the hand-written kernel
   (`raster_cuda.composite_tiles`) over occupancy-ordered rows with the
   `max_live_tiles` cap and the chunk-granular live horizon; backend
   "torch" composites chunks of tiles with an exclusive log-transmittance
   cumsum in plain torch (`_composite_chunk`, the JAX "xla" path),
   recomputed per chunk in the backward (`torch.utils.checkpoint`).

Gradients reach means, covariances, opacities and features through
autograd: the compositor's backward is `raster_cuda`'s (the hand-written
kernel `csrc/composite_bwd.cu` on "cuda"), and the gather's VJP lands the
per-entry cotangents on their splats with one `index_add_` (the JAX
package's sort-and-land transport has no counterpart).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from gaussiansplattingregistration_tpu_torch.ops import math3d, raster_cuda, sh as sh_ops
from gaussiansplattingregistration_tpu_torch.utils import profiling
from gaussiansplattingregistration_tpu_torch.utils.device import as_tensor, resolve_device

_BACKENDS = ("cuda", "torch")


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    """Static rasterization configuration (frozen, hashable); the fields and
    defaults of the JAX package's, except `backend`."""

    tile_size: int = 16
    max_tiles_per_splat: int = 16     # bounded tile coverage per splat
    max_splats_per_tile: int = 256    # top-K front-most splats composited
    tile_chunk: int = 16              # tiles composited per step ("torch")
    radius_clip: float = 3.0          # cull tiny splats (gsplat radius_clip=3)
    near: float = 0.01                # near-plane cull
    eps2d: float = 0.3                # 2D low-pass (3DGS convention)
    alpha_clip: float = 1.0 / 255.0   # minimum visible alpha (3DGS)
    alpha_max: float = 0.999          # saturating alpha (3DGS)
    transmittance_min: float = 1e-4   # early-termination threshold (3DGS)
    # "cuda": the hand-written composite kernel on CUDA tensors, its plain
    # twin on CPU tensors (the JAX "pallas" branch); "torch": chunked plain
    # torch (the JAX "xla" branch).
    backend: str = "cuda"
    # Backward-transport cap: only the first KB = min(this, K) depth ranks
    # of each tile carry gradients back to splats (`bwd_rank_cap`). It sets
    # the table's `live` entries, the `bwd_cap_violations` counter and the
    # gather's VJP. None = K.
    max_bwd_splats_per_tile: Optional[int] = None
    # Cap on PROCESSED tile rows ("cuda"): occupancy-ordered rows put empty
    # tiles last; rows past the cap (rounded up to 8) composite to exact
    # background and carry no gradient, and live tiles past it are counted
    # in `live_tile_overflow`. None = all tiles.
    max_live_tiles: Optional[int] = None
    # Round each per-entry cotangent to bf16 before it lands on its splat
    # (the JAX package's bf16 gradient transport).
    bwd_sort_bf16: bool = False

    def __post_init__(self):
        if self.backend not in _BACKENDS:
            raise ValueError(f"backend must be one of {_BACKENDS}, got {self.backend!r}")


DEFAULT_CONFIG = RasterizeConfig()


def bwd_rank_cap(config: RasterizeConfig) -> int:
    """KB, the depth ranks per tile that carry gradients: the one source of
    the table's `live`, the `bwd_cap_violations` stat and the gather VJP."""
    K = config.max_splats_per_tile
    if config.max_bwd_splats_per_tile is None:
        return K
    return min(config.max_bwd_splats_per_tile, K)


def project_gaussians(
    means: torch.Tensor,        # [N, 3]
    cov3d: torch.Tensor,        # [N, 6] packed
    viewmat: torch.Tensor,      # [4, 4]
    intrinsics: torch.Tensor,   # [3, 3]
    width: int,
    height: int,
    config: RasterizeConfig = DEFAULT_CONFIG,
):
    """EWA projection of 3D Gaussians to screen space.

    Returns dict with means2d [N,2], conic [N,3] (a,b,c of the inverse 2D
    covariance), depth [N], radius [N], valid [N].
    """
    W = viewmat[:3, :3]
    t = viewmat[:3, 3]
    p_view = means @ W.T + t                      # [N, 3]
    z = p_view[:, 2]

    fx = intrinsics[0, 0]
    fy = intrinsics[1, 1]
    cx = intrinsics[0, 2]
    cy = intrinsics[1, 2]

    zc = torch.clamp_min(z, config.near)          # guarded z for the math
    x, y = p_view[:, 0], p_view[:, 1]
    means2d = torch.stack([fx * x / zc + cx, fy * y / zc + cy], dim=-1)

    # 3DGS clamps the tangent-plane extent to 1.3 * fov before the Jacobian.
    lim_x = 1.3 * (width / 2.0) / fx
    lim_y = 1.3 * (height / 2.0) / fy
    tx = zc * torch.clamp(x / zc, -lim_x, lim_x)
    ty = zc * torch.clamp(y / zc, -lim_y, lim_y)

    # Camera-frame covariance: conjugation by W is linear in the packed
    # covariance, so M6 = cov6 @ A(W) is one [N,6]x[6,6] matmul.
    basis = torch.zeros((6, 3, 3), dtype=cov3d.dtype, device=cov3d.device)
    for s, (i, j) in enumerate([(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]):
        basis[s, i, j] = 1.0
        basis[s, j, i] = 1.0
    A = math3d.pack_symmetric(W[None] @ basis @ W.T[None])    # [6, 6]
    M = cov3d @ A                                  # [N, 6] packed W Σ Wᵀ
    m00, m01, m02, m11, m12, m22 = (M[:, i] for i in range(6))

    # cov2d = J M Jᵀ with J = [[a1, 0, b1], [0, a2, b2]].
    a1 = fx / zc
    b1 = -fx * tx / (zc * zc)
    a2 = fy / zc
    b2 = -fy * ty / (zc * zc)
    a = a1 * a1 * m00 + 2.0 * a1 * b1 * m02 + b1 * b1 * m22 + config.eps2d
    b = a1 * a2 * m01 + a1 * b2 * m02 + a2 * b1 * m12 + b1 * b2 * m22
    c = a2 * a2 * m11 + 2.0 * a2 * b2 * m12 + b2 * b2 * m22 + config.eps2d
    det = a * c - b * b
    det = torch.clamp_min(det, 1e-12)
    inv_det = 1.0 / det
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    # Radius: 3 sigma of the larger eigenvalue (3DGS formula).
    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam1))

    inside = (
        (means2d[:, 0] + radius > 0)
        & (means2d[:, 0] - radius < width)
        & (means2d[:, 1] + radius > 0)
        & (means2d[:, 1] - radius < height)
    )
    valid = (z > config.near) & (radius > config.radius_clip) & inside

    return {
        "means2d": means2d,
        "conic": conic,
        "depth": z,
        "radius": torch.where(valid, radius, 0.0),
        "valid": valid,
    }


def compute_view_colors(
    features: torch.Tensor,     # [N, K, 3]
    means: torch.Tensor,        # [N, 3]
    cam_center: torch.Tensor,   # [3]
    sh_degree: int,
) -> torch.Tensor:
    """View-dependent RGB from SH (3DGS: eval + 0.5, clamped at 0)."""
    dirs = math3d.normalize(means - cam_center[None, :])
    rgb = sh_ops.eval_sh(sh_degree, features, dirs) + 0.5
    return torch.clamp_min(rgb, 0.0)


def _depth_bits(tiles_x: int, tiles_y: int) -> int:
    """The fused key's depth bits: 32 less the bits of the image's tile ids
    (the JAX package's u32 key); raises below 8."""
    tile_bits = max(int(tiles_x * tiles_y + 1).bit_length(), 1)
    if 32 - tile_bits < 8:
        raise ValueError(f"too many tiles for fused sort key: {tiles_x * tiles_y}")
    return 32 - tile_bits


def _build_stats(clipped: torch.Tensor, runs: torch.Tensor, K: int) -> dict:
    """The table build's truncation counters, 0-dim int32, from the count
    of clipped splats and each tile's run before truncation."""
    return {
        # valid splats whose coverage exceeds C: trailing tiles skipped
        "coverage_clipped_splats": clipped,
        # tiles whose occupancy exceeded K: back-most splats dropped
        "overflow_tiles": torch.sum(runs > K).to(torch.int32),
        "dropped_entries": torch.sum(torch.clamp_min(runs - K, 0)).to(torch.int32),
        "total_entries": torch.sum(runs).to(torch.int32),
        # largest pre-truncation run: the K an exact render needs
        "max_run": torch.max(runs).to(torch.int32),
    }


def _build_tile_table(
    means2d: torch.Tensor,
    radius: torch.Tensor,
    depth: torch.Tensor,
    valid: torch.Tensor,
    tiles_x: int,
    tiles_y: int,
    config: RasterizeConfig,
    ty_offset: int = 0,
    tiles_y_window: Optional[int] = None,
    with_stats: bool = False,
):
    """Build the per-tile table [num_tiles, K] of depth-sorted ENTRY ids:
    `tile_bin` (the kernels of `csrc/tile_bin.cu`) on CUDA tensors, the
    plain form `_build_tile_table_plain` on CPU tensors. Both give the same
    table, counts, order and counters, integer for integer; on CUDA
    `sorted_entry` covers the emitted entries only and `live` is None (see
    `tile_bin`). The rule reads the device only."""
    build = tile_bin if means2d.device.type == "cuda" else _build_tile_table_plain
    return build(means2d, radius, depth, valid, tiles_x, tiles_y, config,
                 ty_offset=ty_offset, tiles_y_window=tiles_y_window, with_stats=with_stats)


def _build_tile_table_plain(
    means2d: torch.Tensor,
    radius: torch.Tensor,
    depth: torch.Tensor,
    valid: torch.Tensor,
    tiles_x: int,
    tiles_y: int,
    config: RasterizeConfig,
    ty_offset: int = 0,
    tiles_y_window: Optional[int] = None,
    with_stats: bool = False,
):
    """The plain form of `_build_tile_table` over every [N, C] slot.

    Each splat emits up to C = max_tiles_per_splat entries (entry id
    splat_id * C + c); entries sort once by the fused key (tile id in the
    high bits, the top `depth_bits` bits of the f32 depth pattern below);
    equal keys keep entry-id order (a stable sort over entries laid out
    n-major), exactly the JAX package's two-key sort. Invalid entries get
    tile id num_tiles and sort last; each tile keeps its front-most K.

    `ty_offset`/`tiles_y_window` restrict binning to a horizontal tile slab
    with slab-local tile ids. The fused key's depth bits follow the whole
    image's tile count, so a slab's tiles sort, tie-break and truncate as
    on one device (the JAX package's slab keys with its own count).

    Returns (table [T, K] int32 entry ids or -1, sorted_entry [N*C] int32,
    live [N*C] bool (sorted entry in the table and within the first KB
    ranks), counts [T] int32, order, build_stats). On the "cuda" backend
    the rows are in descending-occupancy order (stable) and `order` [T]
    int32 is that permutation (row r = tile order[r]); on "torch" rows are
    in image order and `order` is None. build_stats is None unless
    `with_stats`, else the truncation counters. While tracing is on it
    adds the entries to the counter `raster.bin_entries` and N·C to
    `raster.bin_slots` (a host read of the entries, so on a CUDA tensor
    a synchronize).
    """
    n = means2d.shape[0]
    dev = means2d.device
    ts = float(config.tile_size)
    if tiles_y_window is None:
        tiles_y_window = tiles_y
    num_tiles = tiles_x * tiles_y_window

    def tile_of(v, hi):
        return torch.clamp(torch.floor(v / ts), 0, hi).to(torch.int64)

    tx0 = tile_of(means2d[:, 0] - radius, tiles_x - 1)
    ty0 = tile_of(means2d[:, 1] - radius, tiles_y - 1)
    tx1 = tile_of(means2d[:, 0] + radius, tiles_x - 1)
    ty1 = tile_of(means2d[:, 1] + radius, tiles_y - 1)
    w = tx1 - tx0 + 1
    h = ty1 - ty0 + 1

    C = config.max_tiles_per_splat
    c = torch.arange(C, device=dev)[None, :]            # [1, C]
    # Coverage clipping: a splat touching more than C tiles keeps the
    # w_eff x h_eff sub-window CENTERED on the tile of its projected mean.
    s_eff = max(1, math.isqrt(C))
    w_eff = torch.clamp_max(w, s_eff)
    h_eff = torch.minimum(h, C // torch.clamp_min(w_eff, 1))
    clipped = (w * h) > C
    mtx = tile_of(means2d[:, 0], tiles_x - 1)
    mty = tile_of(means2d[:, 1], tiles_y - 1)
    ox = torch.minimum(torch.clamp_min(mtx - tx0 - (w_eff - 1) // 2, 0), w - w_eff)
    oy = torch.minimum(torch.clamp_min(mty - ty0 - (h_eff - 1) // 2, 0), h - h_eff)
    w_use = torch.where(clipped, w_eff, w)
    h_use = torch.where(clipped, h_eff, h)
    ox = torch.where(clipped, ox, 0)
    oy = torch.where(clipped, oy, 0)
    dx = c % w_use[:, None] + ox[:, None]
    dy = c // w_use[:, None] + oy[:, None]
    local_ty = ty0[:, None] + dy - ty_offset
    entry_valid = (
        (c < (w_use * h_use)[:, None]) & valid[:, None]
        & (local_ty >= 0) & (local_ty < tiles_y_window)
    )
    tile_id = local_ty * tiles_x + (tx0[:, None] + dx)
    tile_id = torch.where(entry_valid, tile_id, num_tiles)

    # Fused key in int64 (torch has no unsigned 32-bit sort); its value is
    # the JAX package's u32 key.
    depth_bits = _depth_bits(tiles_x, tiles_y)
    dbits = (torch.clamp_min(depth, 0.0).to(torch.float32).view(torch.int32)
             .to(torch.int64) & 0xFFFFFFFF)
    key = (tile_id << depth_bits) | (dbits >> (32 - depth_bits))[:, None]
    # Row-major flatten: position == entry id n*C + c, so the stable sort
    # breaks key ties by entry id.
    sorted_key, sorted_entry = torch.sort(key.reshape(-1), stable=True)
    sorted_tiles = sorted_key >> depth_bits
    E = n * C

    K = config.max_splats_per_tile
    KB = bwd_rank_cap(config)
    # Tile runs are contiguous in the sorted order: bounds[t] is run t's
    # start (bounds[num_tiles] the start of the invalid run).
    bounds = torch.searchsorted(
        sorted_tiles, torch.arange(num_tiles + 1, device=dev, dtype=torch.int64))
    runs = bounds[1:] - bounds[:-1]
    rank = torch.arange(E, device=dev) - bounds[sorted_tiles]
    live = (rank < KB) & (sorted_tiles < num_tiles)

    counts = torch.clamp_max(runs, K)
    starts = bounds[:-1]
    order = None
    if config.backend == "cuda":
        # Occupancy order, stable as jnp.argsort is: rows that
        # `max_live_tiles` keeps must be the JAX package's rows.
        order = torch.argsort(-counts, stable=True)
        counts = counts[order]
        starts = starts[order]
    k = torch.arange(K, device=dev)
    # Sentinel at index E keeps the gather in range when runs are short.
    ext = torch.cat([sorted_entry, sorted_entry.new_full((1,), -1)])
    table = torch.where(
        k[None, :] < counts[:, None],
        ext[torch.clamp_max(starts[:, None] + k[None, :], E)],
        -1,
    )

    build_stats = None
    if with_stats:
        build_stats = _build_stats(torch.sum(valid & clipped).to(torch.int32), runs, K)
    if profiling.enabled():
        profiling.count("raster.bin_entries", int(torch.sum(runs)))
        profiling.count("raster.bin_slots", E)
    return (
        table.to(torch.int32),
        sorted_entry.to(torch.int32),
        live,
        counts.to(torch.int32),
        None if order is None else order.to(torch.int32),
        build_stats,
    )


@functools.cache
def _tile_bin_entry(name: str):
    """A C entry point of csrc/tile_bin.cu (built on first use)."""
    import ctypes

    from gaussiansplattingregistration_tpu_torch.ops import _build

    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    geometry = [i] * 7 + [f]      # tiles_x, tiles_y, ty_offset, window, C, s_eff, depth_bits, ts
    fn = getattr(_build.library("tile_bin"), name)
    fn.argtypes = {
        "tile_bin_scan_bytes": [i],
        "tile_bin_sort_bytes": [i],
        "tile_bin_count": [p, p, p, i] + geometry + [p, p, p, p, ll, p],
        "tile_bin_emit_sort": [p, p, p, i, p, i] + geometry + [p, i, p, p, p, ll, p],
        "tile_bin_runs": [p, i, i, i, i, p, p, p, p],
        "tile_bin_fill": [p, p, p, p, i, i, p, p],
    }[name]
    fn.restype = ll if name.endswith("_bytes") else i
    return fn


def _tile_bin_call(name: str, *args) -> int:
    out = _tile_bin_entry(name)(*args)
    if name.endswith("_bytes"):
        if out < 0:
            raise RuntimeError(f"{name} failed: cudaError {-out}")
    elif out != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {out}")
    return out


def tile_bin(
    means2d: torch.Tensor,
    radius: torch.Tensor,
    depth: torch.Tensor,
    valid: torch.Tensor,
    tiles_x: int,
    tiles_y: int,
    config: RasterizeConfig,
    ty_offset: int = 0,
    tiles_y_window: Optional[int] = None,
    with_stats: bool = False,
):
    """`_build_tile_table` on the card by `csrc/tile_bin.cu`: only the slots
    that hold a tile are emitted, in entry-id order, keyed as 32-bit
    (tile | depth bits) keys, and sorted stably (see the source's note).

    Takes means2d [N, 2] and radius [N] float32, depth [N] (any float
    dtype, keyed as float32, as the plain form does) and valid [N] bool on
    one CUDA device, N·C < 2^31; raises on anything else. Returns what
    `_build_tile_table_plain` returns, the table, counts, order and
    counters integer for integer, except that `sorted_entry` [E] int32
    covers the E emitted entries only (the plain form's trailing run of
    empty slots is never built) and `live` is None (the rasterizer reads
    neither). One host read a call: the
    entry count E, 4 bytes, which sizes the sort. Adds one to
    `tile_bin.launches`, E to the counter `raster.bin_entries` and N·C to
    `raster.bin_slots`."""
    for name, x, ok in (("means2d", means2d, means2d.dtype == torch.float32),
                        ("radius", radius, radius.dtype == torch.float32),
                        ("depth", depth, depth.is_floating_point()),
                        ("valid", valid, valid.dtype == torch.bool)):
        if x.device.type != "cuda" or x.device != means2d.device:
            raise ValueError(f"tile_bin needs CUDA tensors on one device, got {name} on "
                             f"{x.device}")
        if not ok:
            raise ValueError(f"tile_bin: {name} of {x.dtype} is not taken")
    n = means2d.shape[0]
    if (tuple(means2d.shape) != (n, 2)
            or any(tuple(x.shape) != (n,) for x in (radius, depth, valid))):
        raise ValueError(f"tile_bin: means2d [N, 2] and radius, depth, valid [N], got "
                         f"{tuple(means2d.shape)}, {tuple(radius.shape)}, "
                         f"{tuple(depth.shape)}, {tuple(valid.shape)}")
    C = config.max_tiles_per_splat
    K = config.max_splats_per_tile
    if n * C >= 1 << 31:
        raise ValueError(f"tile_bin: N·C = {n * C} entry ids do not fit int32")
    if tiles_y_window is None:
        tiles_y_window = tiles_y
    num_tiles = tiles_x * tiles_y_window
    depth_bits = _depth_bits(tiles_x, tiles_y)
    dev = means2d.device
    means2d = means2d.detach().contiguous()
    radius = radius.detach().contiguous()
    depth = depth.detach().to(torch.float32)
    valid = valid.contiguous()
    geometry = (tiles_x, tiles_y, ty_offset, tiles_y_window, C, max(1, math.isqrt(C)),
                depth_bits, float(config.tile_size))
    i32 = functools.partial(torch.empty, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        counts_offsets = i32((2, n + 1))
        clipped = torch.zeros((), dtype=torch.int32, device=dev) if with_stats else None
        # cub's scratch: never a null pointer, which cub reads as a size query.
        scratch = torch.empty(max(_tile_bin_call("tile_bin_scan_bytes", n), 1),
                              dtype=torch.uint8, device=dev)
        _tile_bin_call("tile_bin_count", means2d.data_ptr(), radius.data_ptr(),
                       valid.data_ptr(), n, *geometry, counts_offsets[0].data_ptr(),
                       counts_offsets[1].data_ptr(),
                       None if clipped is None else clipped.data_ptr(),
                       scratch.data_ptr(), scratch.numel(), stream)
        E = int(counts_offsets[1, n])
        # Emitted pairs in [0], sorted pairs in [1]: keys as u32 bits.
        keys, ids = i32((2, E)), i32((2, E))
        if E:
            scratch = torch.empty(max(_tile_bin_call("tile_bin_sort_bytes", E), 1),
                                  dtype=torch.uint8, device=dev)
            _tile_bin_call("tile_bin_emit_sort", means2d.data_ptr(), radius.data_ptr(),
                           depth.data_ptr(), depth.stride(0), valid.data_ptr(), n, *geometry,
                           counts_offsets[1].data_ptr(), E, keys.data_ptr(), ids.data_ptr(),
                           scratch.data_ptr(), scratch.numel(), stream)
        starts_runs, counts = i32((2, num_tiles)), i32((num_tiles,))
        _tile_bin_call("tile_bin_runs", keys[1].data_ptr(), E, num_tiles, depth_bits, K,
                       starts_runs[0].data_ptr(), starts_runs[1].data_ptr(), counts.data_ptr(),
                       stream)
        order = None
        if config.backend == "cuda":
            # Occupancy order, stable, as the plain form's.
            perm = torch.argsort(-counts, stable=True)
            counts, order = counts[perm], perm.to(torch.int32)
        table = i32((num_tiles, K))
        _tile_bin_call("tile_bin_fill", ids[1].data_ptr(), starts_runs[0].data_ptr(),
                       starts_runs[1].data_ptr(), None if order is None else order.data_ptr(),
                       num_tiles, K, table.data_ptr(), stream)
    tile_bin.launches += 1
    profiling.count("raster.bin_entries", E)
    profiling.count("raster.bin_slots", n * C)

    build_stats = _build_stats(clipped, starts_runs[1], K) if with_stats else None
    return table, ids[1], None, counts, order, build_stats


tile_bin.launches = 0


class _GatherEntries(torch.autograd.Function):
    @staticmethod
    def forward(ctx, packed, table, C, k_bwd, sort_bf16):
        filled = table >= 0
        splat = torch.where(filled, torch.div(table, C, rounding_mode="floor"), 0).long()
        g = packed[splat] * filled.to(packed.dtype)[..., None]
        ctx.save_for_backward(table)
        ctx.C, ctx.k_bwd, ctx.sort_bf16, ctx.n = C, k_bwd, sort_bf16, packed.shape[0]
        ctx.request = profiling.request_id()
        # A fresh tensor, so the caller may shift the tile origins in place.
        return g.permute(0, 2, 1).contiguous()

    @staticmethod
    def backward(ctx, ct):
        with profiling.span("raster.gather_vjp", request=ctx.request):
            (table,) = ctx.saved_tensors
            eid = table[:, :ctx.k_bwd]                                   # [T, KB]
            rows = ct[:, :, :ctx.k_bwd].permute(0, 2, 1)                 # [T, KB, F]
            if ctx.sort_bf16:
                rows = rows.to(torch.bfloat16).to(ct.dtype)
            filled = eid >= 0
            d_packed = torch.zeros((ctx.n, ct.shape[1]), dtype=ct.dtype, device=ct.device)
            d_packed.index_add_(0, torch.div(eid[filled], ctx.C, rounding_mode="floor").long(),
                                rows[filled])
        return d_packed, None, None, None, None


def gather_entries(
    packed: torch.Tensor,        # [N, F]
    table: torch.Tensor,         # [T, K] ENTRY ids (splat * C + c) or -1
    C: int,
    k_bwd: Optional[int] = None,
    sort_bf16: bool = False,
) -> torch.Tensor:
    """Gather per-splat rows [N, F] into the CHANNEL-MAJOR tile table layout
    [T, F, K] the composite kernel reads; empty slots are zero (so their
    opacity is zero).

    The VJP takes the cotangent [T, F, K], keeps the first `k_bwd` depth
    ranks of each row (None = all K), rounds each entry's cotangent to bf16
    and back when `sort_bf16` is set, and adds the filled slots' rows onto
    their splats (`splat = table // C`) with one atomic `index_add_` — the
    counterpart of the JAX package's sort-and-land transport. Only the rows
    of `table` land: a tile row left out (past `max_live_tiles`) gives its
    splats no gradient and touches no other splat."""
    return _GatherEntries.apply(packed, table, C, k_bwd, sort_bf16)


def _composite_chunk(
    tile_origin: torch.Tensor,   # [B, 2] pixel origin of each tile
    g: torch.Tensor,             # [B, K, 10] gathered entry params
    entry_valid: torch.Tensor,   # [B, K]
    config: RasterizeConfig,
):
    """Front-to-back alpha compositing of K depth-sorted splats over a chunk
    of B tiles (tile_size² pixels each) via exclusive log-transmittance
    cumsum. Returns (rgb [B, P, 3], alpha [B, P], depth [B, P])."""
    ts = config.tile_size
    m = g[..., 0:2]                 # [B, K, 2]
    co = g[..., 2:5]                # [B, K, 3]
    op = g[..., 5]                  # [B, K]
    col = g[..., 6:9]               # [B, K, 3]
    dep = g[..., 9]                 # [B, K]

    r = torch.arange(ts, dtype=m.dtype, device=m.device) + 0.5
    py, px = torch.meshgrid(r, r, indexing="ij")
    pix = torch.stack([px.reshape(-1), py.reshape(-1)], dim=-1)     # [P, 2]
    pix = tile_origin[:, None, :] + pix[None, :, :]                 # [B, P, 2]

    d = pix[:, None, :, :] - m[:, :, None, :]                       # [B, K, P, 2]
    dx2 = d[..., 0] * d[..., 0]
    dy2 = d[..., 1] * d[..., 1]
    dxdy = d[..., 0] * d[..., 1]
    sigma = (
        0.5 * (co[:, :, None, 0] * dx2 + co[:, :, None, 2] * dy2)
        + co[:, :, None, 1] * dxdy
    )                                                                # [B, K, P]
    alpha = op[:, :, None] * torch.exp(-torch.clamp_min(sigma, 0.0))
    alpha = torch.clamp_max(alpha, config.alpha_max)
    visible = (alpha >= config.alpha_clip) & entry_valid[:, :, None] & (sigma >= 0.0)
    alpha = torch.where(visible, alpha, 0.0)

    log_t = torch.log1p(-alpha)
    log_T_excl = torch.cumsum(log_t, dim=1) - log_t
    T = torch.exp(log_T_excl)
    # 3DGS early termination: stop once transmittance falls below 1e-4.
    w = torch.where(T > config.transmittance_min, alpha * T, 0.0)  # [B, K, P]

    rgb = torch.einsum("bkp,bkc->bpc", w, col)
    acc_alpha = torch.sum(w, dim=1)
    acc_depth = torch.einsum("bkp,bk->bp", w, dep)
    return rgb, acc_alpha, acc_depth


def _row_cap(config: RasterizeConfig, num_tiles: int) -> int:
    """Rows the "cuda" backend processes: max_live_tiles rounded up to 8."""
    if config.max_live_tiles is None:
        return num_tiles
    return min(num_tiles, -(-config.max_live_tiles // 8) * 8)


def rasterize_tile_slab(
    means2d: torch.Tensor,
    conic: torch.Tensor,
    depth: torch.Tensor,
    radius: torch.Tensor,
    valid: torch.Tensor,
    colors: torch.Tensor,
    opacity: torch.Tensor,
    tiles_x: int,
    tiles_y: int,
    config: RasterizeConfig,
    ty_offset: int = 0,
    tiles_y_window: Optional[int] = None,
    with_stats: bool = False,
):
    """Bin + sort + composite projected splats over a horizontal tile slab.

    Returns (rgb [win_h, W, 3], alpha [win_h, W], depth [win_h, W]) with
    win_h = tiles_y_window * tile_size and W = tiles_x * tile_size (callers
    crop). With `with_stats`, a fourth element: the counters of
    `rasterize_arrays_with_stats`.
    """
    ts = config.tile_size
    if tiles_y_window is None:
        tiles_y_window = tiles_y
    num_tiles = tiles_x * tiles_y_window
    dev = means2d.device

    def tiles_to_image(tiles, ch):
        img = tiles.reshape(tiles_y_window, tiles_x, ts, ts, ch)
        return img.permute(0, 2, 1, 3, 4).reshape(
            tiles_y_window * ts, tiles_x * ts, ch
        )

    with profiling.span("raster.bin"):
        table, _, _, counts, order, build_stats = _build_tile_table(
            means2d, radius, depth, valid, tiles_x, tiles_y, config,
            ty_offset=ty_offset, tiles_y_window=tiles_y_window,
            with_stats=with_stats,
        )                                                     # [T, K]

    C = config.max_tiles_per_splat
    KB = bwd_rank_cap(config)
    with profiling.span("raster.gather"):
        op = opacity * valid.to(opacity.dtype)
        tile_ids = torch.arange(num_tiles, device=dev)
        tile_origin = torch.stack(
            [(tile_ids % tiles_x) * ts, (tile_ids // tiles_x + ty_offset) * ts],
            dim=-1,
        ).to(means2d.dtype)
        if order is not None:
            tile_origin = tile_origin[order.long()]

        packed = torch.cat(
            [means2d, conic, op[:, None], colors, depth[:, None]], dim=-1
        )                                                     # [N, 10]
        if config.backend == "cuda":
            # Occupancy-ordered rows put empty tiles last: rows past the cap
            # are not gathered or composited and stay background.
            T_live = _row_cap(config, num_tiles)
            gT = gather_entries(packed, table[:T_live], C, KB,
                                config.bwd_sort_bf16)         # [T_live, 10, K]
            # Tile-LOCAL means keep the quadratic form exact in f32 (in
            # place: the gather returns a fresh tensor).
            gT[:, 0:2, :] -= tile_origin[:T_live, :, None]
            live_counts = counts[:T_live, None].to(means2d.dtype)
        else:
            g = gather_entries(packed, table, C, KB,
                               config.bwd_sort_bf16).permute(0, 2, 1)  # [T, K, 10]
            filled = table >= 0

    if config.backend == "cuda":
        rgb, alpha, depthmap, live = raster_cuda.composite_tiles(gT, live_counts, ts, config)
    else:
        with profiling.span("raster.composite"):
            B = config.tile_chunk
            # Under autograd each chunk is recomputed in the backward
            # instead of keeping its [B, K, P] intermediates (the JAX
            # jax.checkpoint).
            composite = _composite_chunk
            if g.requires_grad:
                composite = functools.partial(checkpoint, _composite_chunk, use_reentrant=False)
            parts = [
                composite(tile_origin[s:s + B], g[s:s + B], filled[s:s + B], config)
                for s in range(0, num_tiles, B)
            ]
            rgb, alpha, depthmap = (torch.cat(p) for p in zip(*parts))
        live = None   # composites every occupied slot

    with profiling.span("raster.unpack"):
        if config.backend == "cuda":
            padr = num_tiles - T_live
            rgb = F.pad(rgb, (0, 0, 0, 0, 0, padr))
            alpha = F.pad(alpha, (0, 0, 0, padr))
            depthmap = F.pad(depthmap, (0, 0, 0, padr))
            live = F.pad(live, (0, padr))
            # Restore image (tile-id) order.
            inv_order = torch.argsort(order.long())
            rgb, alpha, depthmap = rgb[inv_order], alpha[inv_order], depthmap[inv_order]
        out = (
            tiles_to_image(rgb, 3),
            tiles_to_image(alpha[..., None], 1)[..., 0],
            tiles_to_image(depthmap[..., None], 1)[..., 0],
        )

    if with_stats:
        # Without a horizon output ("torch") report the conservative bound,
        # occupancy.
        effective = counts if live is None else torch.minimum(counts, live.to(torch.int32))
        stats = dict(build_stats or {})
        stats.update({
            "bwd_cap_violations": torch.sum(effective > KB).to(torch.int32),
            "max_live": torch.max(effective).to(torch.int32),
            "mean_live": torch.mean(effective.to(torch.float32)),
            "max_count": torch.max(counts).to(torch.int32),
        })
        if config.backend == "cuda":
            # live tiles past the processed-row cap: rendered as background
            stats["live_tile_overflow"] = torch.sum(
                counts[_row_cap(config, num_tiles):] > 0
            ).to(torch.int32)

    return out + (stats,) if with_stats else out


def _rasterize(means, cov3d, opacity, features, viewmat, intrinsics, width,
               height, sh_degree, background, config, device, with_stats):
    with profiling.span("raster.frame"):
        dev = resolve_device(device)
        means, cov3d, opacity, features, viewmat, intrinsics, background = (
            as_tensor(a, dev) for a in
            (means, cov3d, opacity, features, viewmat, intrinsics, background))
        ts = config.tile_size
        tiles_x = -(-width // ts)
        tiles_y = -(-height // ts)

        with profiling.span("raster.project"):
            proj = project_gaussians(means, cov3d, viewmat, intrinsics, width, height, config)
        with profiling.span("raster.sh"):
            cam_center = -(viewmat[:3, :3].T @ viewmat[:3, 3])
            colors = compute_view_colors(features, means, cam_center, sh_degree)

        out = rasterize_tile_slab(
            proj["means2d"], proj["conic"], proj["depth"], proj["radius"],
            proj["valid"], colors, opacity, tiles_x, tiles_y, config,
            with_stats=with_stats,
        )
        with profiling.span("raster.unpack"):
            img_rgb = out[0][:height, :width]
            img_alpha = out[1][:height, :width]
            img_depth = out[2][:height, :width]
            img_rgb = img_rgb + (1.0 - img_alpha[..., None]) * background[None, None, :]
        return (img_rgb, img_alpha, img_depth) + tuple(out[3:])


def rasterize_arrays(
    means,
    cov3d,
    opacity,                  # [N] activated (sigmoid applied)
    features,                 # [N, K, 3] SH stack (DC first)
    viewmat,
    intrinsics,
    width: int,
    height: int,
    sh_degree: int,
    background,               # [3]
    config: RasterizeConfig = DEFAULT_CONFIG,
    device=None,
):
    """Core functional rasterizer over raw arrays, on `device` (default
    `cuda`). Returns (rgb [H, W, 3], alpha [H, W], depth [H, W])."""
    return _rasterize(means, cov3d, opacity, features, viewmat, intrinsics,
                      width, height, sh_degree, background, config, device,
                      with_stats=False)


def rasterize_arrays_with_stats(
    means,
    cov3d,
    opacity,
    features,
    viewmat,
    intrinsics,
    width: int,
    height: int,
    sh_degree: int,
    background,
    config: RasterizeConfig = DEFAULT_CONFIG,
    device=None,
):
    """`rasterize_arrays` plus the truncation/termination counters, a dict
    of 0-dim tensors:

    - coverage_clipped_splats: valid splats covering more than
      `max_tiles_per_splat` tiles — their trailing tiles are skipped.
    - overflow_tiles / dropped_entries / total_entries / max_run: tiles
      whose occupancy exceeded `max_splats_per_tile`; the back-most entries
      are dropped, front-most kept.
    - bwd_cap_violations: tiles whose early-termination horizon exceeds
      `max_bwd_splats_per_tile` ("torch" reports the occupancy bound).
    - max_live / mean_live: per-tile early-termination horizon
      (chunk-granular; occupancy on "torch").
    - max_count: maximum post-truncation tile occupancy.
    - live_tile_overflow ("cuda" only): live tiles past `max_live_tiles`.
      They render as background and their splats get no gradient from
      them; no other splat's gradient changes (the JAX package's transport
      misaligns every splat's gradient there, so parity holds only at 0).

    Zero counters == the static bounds were exact for this scene/view.
    """
    return _rasterize(means, cov3d, opacity, features, viewmat, intrinsics,
                      width, height, sh_degree, background, config, device,
                      with_stats=True)


def rasterize(
    cloud,
    camera,
    background=(0.0, 0.0, 0.0),
    scaling_modifier: float = 1.0,
    config: RasterizeConfig = DEFAULT_CONFIG,
    device=None,
):
    """Render a GaussianCloud from a Camera on `device` (default `cuda`):
    scale-modified covariances, sigmoid opacity, SH features, background
    color. Returns (rgb [H, W, 3], alpha [H, W], depth [H, W])."""
    return rasterize_arrays(
        cloud.xyz,
        cloud.get_covariance(scaling_modifier),
        cloud.get_opacity[:, 0],
        cloud.get_features,
        camera.viewmat,
        camera.intrinsics,
        camera.width,
        camera.height,
        cloud.sh_degree,
        background,
        config,
        device=device,
    )
