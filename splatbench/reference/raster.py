"""The render cells' plain reference: a float32 tile rasterizer in plain torch.

It computes from the raw inputs (means, packed 3D covariances, activated
opacities, SH features, a view matrix and intrinsics) what the rasterizer
under test must produce, and its gradients by autograd:

1. projection: EWA splatting with the 0.3 px low-pass, the 1.3·FoV clamp of
   the Jacobian and the 3-sigma radius (the formula of 3DGS, as the port
   states it);
2. view colours: SH evaluation, +0.5, clamped at 0 (`frozen/sh.py`);
3. binning under the configuration's bounds: each splat emits at most C
   tiles (the centred window where it covers more), one stable sort over a
   fused (tile | quantized depth) key, and each tile keeps its front-most K;
4. compositing: front to back by an exclusive log-transmittance cumsum, with
   the alpha_clip / alpha_max / sigma masks and 3DGS early termination, and
   one weighted sum over each entry's (r, g, b, depth, 1), over chunks of
   tiles, each recomputed in the backward.

Steps 1 and 3 are frozen copies of the port's formulas (they decide which
splat lands in which tile and in which order, so they are copied op for op);
step 4 is written here. Nothing of the port is imported. Matmuls run in
float32 with TF32 off unless `precision(tf32=True)` asks for the lower
precision, which is the control's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math

import torch
from torch.utils.checkpoint import checkpoint

from splatbench.reference.frozen import math3d, sh


@dataclasses.dataclass(frozen=True)
class RasterParams:
    """The rasterizer's bounds and thresholds, as a configuration states them."""

    max_tiles_per_splat: int
    max_splats_per_tile: int
    tile_size: int = 16
    radius_clip: float = 3.0
    near: float = 0.01
    eps2d: float = 0.3
    alpha_clip: float = 1.0 / 255.0
    alpha_max: float = 0.999
    transmittance_min: float = 1e-4

    @classmethod
    def from_config(cls, rasterizer: dict) -> "RasterParams":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in rasterizer.items() if k in names})


@contextlib.contextmanager
def precision(tf32: bool):
    """Matmuls in TF32 (`tf32`) or in float32 for the duration; restores the
    previous setting."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def camera(yaw: float, width: int, height: int, fov_deg: float, distance: float, device):
    """(viewmat [4, 4], intrinsics [3, 3]): a camera `distance` in front of
    the origin, turned by `yaw` radians about y, with a horizontal field of
    view of `fov_deg` and the principal point at the image centre."""
    c, s = math.cos(yaw), math.sin(yaw)
    rot = torch.tensor([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], dtype=torch.float64)
    view = torch.eye(4, dtype=torch.float64)
    view[:3, :3] = rot.T
    view[2, 3] = distance
    f = width / (2.0 * math.tan(math.radians(fov_deg) / 2.0))
    intr = torch.tensor([[f, 0.0, width / 2.0], [0.0, f, height / 2.0], [0.0, 0.0, 1.0]],
                        dtype=torch.float64)
    return view.to(torch.float32).to(device), intr.to(torch.float32).to(device)


def project(means, cov6, viewmat, intr, width: int, height: int, p: RasterParams) -> dict:
    """EWA projection: means2d [N, 2], conic [N, 3], depth [N], radius [N],
    valid [N] (a frozen copy of the port's formula)."""
    W = viewmat[:3, :3]
    t = viewmat[:3, 3]
    p_view = means @ W.T + t
    z = p_view[:, 2]
    fx, fy, cx, cy = intr[0, 0], intr[1, 1], intr[0, 2], intr[1, 2]
    zc = torch.clamp_min(z, p.near)
    x, y = p_view[:, 0], p_view[:, 1]
    means2d = torch.stack([fx * x / zc + cx, fy * y / zc + cy], dim=-1)
    lim_x = 1.3 * (width / 2.0) / fx
    lim_y = 1.3 * (height / 2.0) / fy
    tx = zc * torch.clamp(x / zc, -lim_x, lim_x)
    ty = zc * torch.clamp(y / zc, -lim_y, lim_y)
    basis = torch.zeros((6, 3, 3), dtype=cov6.dtype, device=cov6.device)
    for s, (i, j) in enumerate([(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]):
        basis[s, i, j] = 1.0
        basis[s, j, i] = 1.0
    A = math3d.pack_symmetric(W[None] @ basis @ W.T[None])
    M = cov6 @ A
    m00, m01, m02, m11, m12, m22 = (M[:, i] for i in range(6))
    a1 = fx / zc
    b1 = -fx * tx / (zc * zc)
    a2 = fy / zc
    b2 = -fy * ty / (zc * zc)
    a = a1 * a1 * m00 + 2.0 * a1 * b1 * m02 + b1 * b1 * m22 + p.eps2d
    b = a1 * a2 * m01 + a1 * b2 * m02 + a2 * b1 * m12 + b1 * b2 * m22
    c = a2 * a2 * m11 + 2.0 * a2 * b2 * m12 + b2 * b2 * m22 + p.eps2d
    det = torch.clamp_min(a * c - b * b, 1e-12)
    inv_det = 1.0 / det
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)
    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam1))
    inside = ((means2d[:, 0] + radius > 0) & (means2d[:, 0] - radius < width)
              & (means2d[:, 1] + radius > 0) & (means2d[:, 1] - radius < height))
    valid = (z > p.near) & (radius > p.radius_clip) & inside
    return {"means2d": means2d, "conic": conic, "depth": z,
            "radius": torch.where(valid, radius, 0.0), "valid": valid}


def view_colors(features, means, viewmat, sh_degree: int):
    """[N, 3] view-dependent colours: SH at the direction from the camera
    centre, +0.5, clamped at 0."""
    centre = -(viewmat[:3, :3].T @ viewmat[:3, 3])
    dirs = math3d.normalize(means - centre[None, :])
    return torch.clamp_min(sh.eval_sh(sh_degree, features, dirs) + 0.5, 0.0)


def bin_tiles(means2d, radius, depth, valid, tiles_x: int, tiles_y: int, p: RasterParams,
              max_splats_per_tile=None, max_tiles_per_splat=None) -> dict:
    """The tile table under bounded coverage and a per-tile cap (a frozen
    copy of the port's binning, rows in image order). Returns `table`
    [T, K] splat ids or -1, `counts` [T] and the truncation counters
    `max_run`, `overflow_tiles`, `dropped_entries`, `total_entries`,
    `coverage_clipped_splats` (0-dim tensors)."""
    n, dev = means2d.shape[0], means2d.device
    ts = float(p.tile_size)
    num_tiles = tiles_x * tiles_y
    C = max_tiles_per_splat or p.max_tiles_per_splat
    K = max_splats_per_tile or p.max_splats_per_tile

    def tile_of(v, hi):
        return torch.clamp(torch.floor(v / ts), 0, hi).to(torch.int64)

    tx0 = tile_of(means2d[:, 0] - radius, tiles_x - 1)
    ty0 = tile_of(means2d[:, 1] - radius, tiles_y - 1)
    tx1 = tile_of(means2d[:, 0] + radius, tiles_x - 1)
    ty1 = tile_of(means2d[:, 1] + radius, tiles_y - 1)
    w = tx1 - tx0 + 1
    h = ty1 - ty0 + 1
    c = torch.arange(C, device=dev)[None, :]
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
    local_ty = ty0[:, None] + dy
    entry_valid = ((c < (w_use * h_use)[:, None]) & valid[:, None]
                   & (local_ty >= 0) & (local_ty < tiles_y))
    tile_id = torch.where(entry_valid, local_ty * tiles_x + (tx0[:, None] + dx), num_tiles)
    tile_bits = max(int(tiles_x * tiles_y + 1).bit_length(), 1)
    depth_bits = 32 - tile_bits
    dbits = (torch.clamp_min(depth, 0.0).to(torch.float32).view(torch.int32)
             .to(torch.int64) & 0xFFFFFFFF)
    key = (tile_id << depth_bits) | (dbits >> (32 - depth_bits))[:, None]
    sorted_key, sorted_entry = torch.sort(key.reshape(-1), stable=True)
    sorted_tiles = sorted_key >> depth_bits
    E = n * C
    bounds = torch.searchsorted(
        sorted_tiles, torch.arange(num_tiles + 1, device=dev, dtype=torch.int64))
    runs = bounds[1:] - bounds[:-1]
    counts = torch.clamp_max(runs, K)
    k = torch.arange(K, device=dev)
    ext = torch.cat([torch.div(sorted_entry, C, rounding_mode="floor"),
                     sorted_entry.new_full((1,), -1)])
    table = torch.where(k[None, :] < counts[:, None],
                        ext[torch.clamp_max(bounds[:-1, None] + k[None, :], E)], -1)
    return {
        "table": table,
        "counts": counts,
        "max_run": torch.max(runs),
        "overflow_tiles": torch.sum(runs > K),
        "dropped_entries": torch.sum(torch.clamp_min(runs - K, 0)),
        "total_entries": torch.sum(runs),
        "coverage_clipped_splats": torch.sum(valid & clipped),
    }


def tile_origins(tiles_x: int, tiles_y: int, ts: int, device) -> torch.Tensor:
    """[T, 2] pixel origin of each tile, row-major tile ids."""
    ids = torch.arange(tiles_x * tiles_y, device=device)
    return torch.stack([(ids % tiles_x) * ts, (ids // tiles_x) * ts], dim=-1).to(torch.float32)


def tile_alpha(origin, g, filled, p: RasterParams):
    """Each (tile, entry, pixel)'s alpha after the masks, [B, K, P], and the
    raw alpha, for a chunk of B tiles: `g` [B, K, 6] holds the entries'
    means2d, conic and opacity, `filled` [B, K] the occupied slots."""
    ts = p.tile_size
    r = torch.arange(ts, dtype=g.dtype, device=g.device) + 0.5
    py, px = torch.meshgrid(r, r, indexing="ij")
    pix = origin[:, None, :] + torch.stack([px.reshape(-1), py.reshape(-1)], dim=-1)[None]
    dx = pix[:, None, :, 0] - g[:, :, None, 0]
    dy = pix[:, None, :, 1] - g[:, :, None, 1]
    sigma = (0.5 * (g[:, :, None, 2] * dx * dx + g[:, :, None, 4] * dy * dy)
             + g[:, :, None, 3] * dx * dy)
    raw = g[:, :, None, 5] * torch.exp(-torch.clamp_min(sigma, 0.0))
    alpha = torch.clamp_max(raw, p.alpha_max)
    keep = (alpha >= p.alpha_clip) & (sigma >= 0.0) & filled[:, :, None]
    return torch.where(keep, alpha, 0.0), raw


def transmittance(alpha):
    """Exclusive front-to-back transmittance [B, K, P] of alphas [B, K, P]."""
    lt = torch.log1p(-alpha)
    return torch.exp(torch.cumsum(lt, dim=1) - lt)


def _composite_chunk(origin, g, filled, p: RasterParams):
    alpha, _ = tile_alpha(origin, g[..., :6], filled, p)
    T = transmittance(alpha)
    w = torch.where(T > p.transmittance_min, alpha * T, 0.0)         # [B, K, P]
    # One weighted sum over the value rows (r, g, b, depth, 1).
    values = torch.cat([g[..., 6:10], torch.ones_like(g[..., :1])], dim=-1)
    out = torch.einsum("bkp,bkc->bpc", w, values)                    # [B, P, 5]
    return out[..., :3], out[..., 4], out[..., 3]


def render(means, cov6, opacity, features, viewmat, intr, width: int, height: int,
           sh_degree: int, p: RasterParams, chunk: int = 32, max_splats_per_tile=None,
           max_tiles_per_splat=None, with_table: bool = False):
    """(rgb [H, W, 3], alpha [H, W], depth [H, W]) on a black background,
    differentiable in the four splat inputs; with `with_table` also the
    binning dict of `bin_tiles`. Chunks of `chunk` tiles are recomputed in
    the backward instead of keeping their [chunk, K, P] intermediates."""
    ts = p.tile_size
    tiles_x, tiles_y = -(-width // ts), -(-height // ts)
    proj = project(means, cov6, viewmat, intr, width, height, p)
    colors = view_colors(features, means, viewmat, sh_degree)
    binning = bin_tiles(proj["means2d"].detach(), proj["radius"].detach(),
                        proj["depth"].detach(), proj["valid"], tiles_x, tiles_y, p,
                        max_splats_per_tile, max_tiles_per_splat)
    table = binning["table"]
    op = opacity * proj["valid"].to(opacity.dtype)
    packed = torch.cat([proj["means2d"], proj["conic"], op[:, None], colors,
                        proj["depth"][:, None]], dim=-1)                # [N, 10]
    filled = table >= 0
    g = packed[torch.where(filled, table, 0)] * filled[..., None].to(packed.dtype)
    origin = tile_origins(tiles_x, tiles_y, ts, means.device)
    step = _composite_chunk
    if g.requires_grad:
        step = functools.partial(checkpoint, _composite_chunk, use_reentrant=False)
    parts = [step(origin[s:s + chunk], g[s:s + chunk], filled[s:s + chunk], p)
             for s in range(0, table.shape[0], chunk)]
    rgb, alpha, depth = (torch.cat(x) for x in zip(*parts))

    def image(tiles, ch):
        img = tiles.reshape(tiles_y, tiles_x, ts, ts, ch).permute(0, 2, 1, 3, 4)
        return img.reshape(tiles_y * ts, tiles_x * ts, ch)[:height, :width]

    out = (image(rgb, 3), image(alpha[..., None], 1)[..., 0], image(depth[..., None], 1)[..., 0])
    return out + (binning,) if with_table else out
