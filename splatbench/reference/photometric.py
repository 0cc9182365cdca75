"""The photometric cell's plain reference: one step of photometric pose
refinement in plain float32 torch.

Given the twist `xi`, the initial transform, both captures' raw arrays
(means, packed covariances, activated opacities, SH features), the views
and their targets, it computes for each view what the program's step must
produce there:

1. the pose T = exp(xi) @ T_init (`se3_exp`, written here), the moving
   capture's means R x + t and covariances R Σ Rᵀ (`frozen/math3d.py`),
   concatenated with the fixed capture;
2. the render by `raster.render`, clipped to [0, 1];
3. the view's loss, ((1 - w) L1 + w (1 - SSIM)) / views, with SSIM written
   here (11x11 Gaussian window, sigma 1.5, same-padded, C1 = 0.01²,
   C2 = 0.03²);
4. the view's gradient with respect to `xi`, by autograd.

One Adam step is written out by its formula (`adam_step`). SH is not
rotated with the pose, as the program states. `exact_render` is the
truncation oracle: every tile a splat covers (no per-splat tile bound) and
every entry of every tile. Nothing of the port is imported; matmuls and
convolutions run in float32 with TF32 off unless `raster.precision(tf32=
True)` asks otherwise.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from splatbench.reference import raster
from splatbench.reference.frozen import math3d


def _skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([o, -z, y, z, o, -x, -y, x, o]).reshape(3, 3)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """[4, 4] exp of the twist xi = (rho, phi): R by Rodrigues, t = V rho,
    with second-order series below theta² = 1e-8."""
    rho, phi = xi[:3], xi[3:]
    theta2 = torch.sum(phi * phi)
    theta = torch.sqrt(torch.clamp_min(theta2, 1e-16))
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp_min(theta2, 1e-16))
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / torch.clamp_min(theta2 * theta, 1e-8))
    K = _skew(phi)
    K2 = K @ K
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + a * K + b * K2
    t = (eye + b * K + c * K2) @ rho
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=xi.dtype, device=xi.device)
    return torch.cat([torch.cat([R, t[:, None]], dim=1), bottom])


def ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two [H, W, 3] images: per channel, an 11x11 Gaussian
    window (sigma 1.5), zero-padded to the same size."""
    a, b = img1.permute(2, 0, 1)[None], img2.permute(2, 0, 1)[None]
    xs = torch.arange(11, dtype=img1.dtype, device=img1.device) - 5.0
    g = torch.exp(-(xs * xs) / (2.0 * 1.5 * 1.5))
    g = g / g.sum()
    kernel = (g[:, None] * g[None, :]).expand(3, 1, 11, 11)

    def blur(x):
        return F.conv2d(x, kernel, padding=5, groups=3)

    mu1, mu2 = blur(a), blur(b)
    s11 = blur(a * a) - mu1 * mu1
    s22 = blur(b * b) - mu2 * mu2
    s12 = blur(a * b) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    num = (2.0 * mu1 * mu2 + c1) * (2.0 * s12 + c2)
    den = (mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2)
    return torch.mean(num / den)


def posed_arrays(xi, t_init, moving: dict, fixed: dict | None) -> tuple:
    """(means, cov6, opacity, features) of the moving capture at exp(xi) @
    T_init, followed by the fixed capture's."""
    T = se3_exp(xi) @ t_init
    R = T[:3, :3]
    means = moving["means"] @ R.T + T[:3, 3]
    cov = math3d.transform_covariance(moving["cov"], R)
    out = [means, cov, moving["opacity"], moving["features"]]
    if fixed is not None:
        out = [torch.cat([a, fixed[k]]) for a, k in zip(out, ("means", "cov", "opacity",
                                                               "features"))]
    return tuple(out)


def view_loss(rgb, target, ssim_weight: float, views: int) -> torch.Tensor:
    """One view's share of the step's loss from its clipped render."""
    l1 = torch.mean(torch.abs(rgb - target))
    if ssim_weight > 0:
        l1 = (1.0 - ssim_weight) * l1 + ssim_weight * (1.0 - ssim(rgb, target))
    return l1 / views


def view_step(xi, t_init, moving: dict, fixed: dict | None, view, target, width: int,
              height: int, sh_degree: int, p: raster.RasterParams, ssim_weight: float,
              views: int) -> dict:
    """One view of a step at `xi`: `rgb` (the clipped render), `loss` (the
    view's share) and `grad` (d loss / d xi), all detached."""
    x = xi.detach().clone().requires_grad_(True)
    vm, intr = view
    rgb, _, _ = raster.render(*posed_arrays(x, t_init, moving, fixed), vm, intr, width,
                              height, sh_degree, p)
    rgb = torch.clamp(rgb, 0.0, 1.0)
    loss = view_loss(rgb, target, ssim_weight, views)
    (grad,) = torch.autograd.grad(loss, x)
    return {"rgb": rgb.detach(), "loss": loss.detach(), "grad": grad}


def adam_step(xi, grad, m, v, t: int, lr: float, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8) -> tuple:
    """(xi, m, v) after Adam's step `t` (from 1): m = b1 m + (1 - b1) g,
    v = b2 v + (1 - b2) g², xi -= lr m̂ / (sqrt(v̂) + eps) with the
    bias-corrected moments."""
    m = b1 * m + (1.0 - b1) * grad
    v = b2 * v + (1.0 - b2) * grad * grad
    m_hat = m / (1.0 - b1 ** t)
    v_hat = v / (1.0 - b2 ** t)
    return xi - lr * m_hat / (torch.sqrt(v_hat) + eps), m, v


def exact_table(means2d, radius, depth, valid, tiles_x: int, tiles_y: int,
                p: raster.RasterParams, k_round: int) -> tuple:
    """(table [T, K] splat ids or -1, K): every tile each valid splat's box
    covers, each tile's entries in `raster.bin_tiles`' order (the fused
    tile | quantized-depth key, ties by splat id), K the longest run
    rounded up to `k_round`."""
    dev = means2d.device
    ts = float(p.tile_size)
    num_tiles = tiles_x * tiles_y

    def tile_of(v, hi):
        return torch.clamp(torch.floor(v / ts), 0, hi).to(torch.int64)

    ids = torch.nonzero(valid)[:, 0]
    m, r = means2d[ids], radius[ids]
    tx0, tx1 = tile_of(m[:, 0] - r, tiles_x - 1), tile_of(m[:, 0] + r, tiles_x - 1)
    ty0, ty1 = tile_of(m[:, 1] - r, tiles_y - 1), tile_of(m[:, 1] + r, tiles_y - 1)
    w, h = tx1 - tx0 + 1, ty1 - ty0 + 1
    n_cov = w * h
    owner = torch.repeat_interleave(torch.arange(ids.numel(), device=dev), n_cov)
    first = torch.cumsum(n_cov, 0) - n_cov
    c = torch.arange(owner.numel(), device=dev) - first[owner]
    tile = (ty0[owner] + c // w[owner]) * tiles_x + tx0[owner] + c % w[owner]
    tile_bits = max(int(num_tiles + 1).bit_length(), 1)
    depth_bits = 32 - tile_bits
    dbits = (torch.clamp_min(depth[ids], 0.0).to(torch.float32).view(torch.int32)
             .to(torch.int64) & 0xFFFFFFFF) >> (32 - depth_bits)
    key = (tile << depth_bits) | dbits[owner]
    sorted_key, order = torch.sort(key, stable=True)
    sorted_tiles = sorted_key >> depth_bits
    bounds = torch.searchsorted(sorted_tiles, torch.arange(num_tiles + 1, device=dev))
    runs = bounds[1:] - bounds[:-1]
    K = max(k_round, -(-int(runs.max()) // k_round) * k_round)
    k = torch.arange(K, device=dev)
    splat = torch.cat([ids[owner[order]], ids.new_full((1,), -1)])
    table = torch.where(k[None, :] < runs[:, None],
                        splat[torch.clamp_max(bounds[:-1, None] + k[None, :], owner.numel())], -1)
    return table, K


@torch.no_grad()
def exact_render(means, cov6, opacity, features, viewmat, intr, width: int, height: int,
                 sh_degree: int, p: raster.RasterParams, k_round: int = 128,
                 chunk: int = 8) -> tuple:
    """(rgb [H, W, 3] on black, K, the tiles holding an entry):
    `raster.render`'s compositing over `exact_table`, with no bound on the
    tiles of a splat or the entries of a tile."""
    ts = p.tile_size
    tiles_x, tiles_y = -(-width // ts), -(-height // ts)
    proj = raster.project(means, cov6, viewmat, intr, width, height, p)
    colors = raster.view_colors(features, means, viewmat, sh_degree)
    table, K = exact_table(proj["means2d"], proj["radius"], proj["depth"], proj["valid"],
                           tiles_x, tiles_y, p, k_round)
    op = opacity * proj["valid"].to(opacity.dtype)
    packed = torch.cat([proj["means2d"], proj["conic"], op[:, None], colors,
                        proj["depth"][:, None]], dim=-1)
    origin = raster.tile_origins(tiles_x, tiles_y, ts, means.device)
    parts = []
    for s in range(0, table.shape[0], chunk):
        rows = table[s:s + chunk]
        filled = rows >= 0
        g = packed[torch.where(filled, rows, 0)] * filled[..., None].to(packed.dtype)
        parts.append(raster._composite_chunk(origin[s:s + chunk], g, filled, p)[0])
    rgb = torch.cat(parts).reshape(tiles_y, tiles_x, ts, ts, 3).permute(0, 2, 1, 3, 4)
    live = int((table[:, 0] >= 0).sum())
    return rgb.reshape(tiles_y * ts, tiles_x * ts, 3)[:height, :width], K, live


def psnr(a, b) -> float:
    mse = float(torch.mean((a - b) ** 2))
    return 10.0 * math.log10(1.0 / max(mse, 1e-12))
