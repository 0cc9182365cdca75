"""The tile compositor's work on one frame, counted from the frame's raw
inputs through the reference's binning under the configuration's C and K.

Whatever implements the compositor, a frame needs:

- `pairs`: the (pixel, entry) pairs it composites: the entry is within its
  tile's count, the pixel's transmittance before it is above
  transmittance_min, and its alpha passes the alpha_clip, alpha_max and
  sigma masks;
- `entries`: the (tile, entry) pairs each tile needs, up to its exact
  early-termination horizon: every entry up to the last one that some pixel
  of the tile still sees alive (transmittance above transmittance_min),
  within the tile's count;
- `pixels`: the image's pixels.

Operations are charged per composited pair, counted once from the
compositor's formulas (an FMA as two; an exp, a division, a compare or a
select as one): the visibility test, `OPS_TEST` = 18 (dx and dy 2, sigma 9,
its clamp and the exp 2, raw alpha and the alpha_max clamp 2, the
alpha_clip, sigma and T tests 3); the forward's compositing,
`OPS_VISIBLE_FWD` = 12 (w 1, the transmittance update 2, the alpha, rgb and
depth sums 9); the backward's, `OPS_VISIBLE_BWD` = 55 (w 1, the
transmittance update 2, dL/dw 8, prefix and suffix 3, dL/dalpha 4, the
alpha_max and sigma masks 4, the ten per-entry values 23, their pixel sums
10). Bytes: each needed entry's ten float32 parameters read once, the image
(rgb, alpha, depth) written once; the backward reads the needed entries and
the image's cotangents once and writes each needed entry's ten gradients
once.
"""

from __future__ import annotations

import json
import os

import torch

from splatbench.reference import raster

OPS_TEST = 18
OPS_VISIBLE_FWD = 12
OPS_VISIBLE_BWD = 55
ENTRY_BYTES = 10 * 4
PIXEL_BYTES = 5 * 4

_PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")


def peaks(device_name: str):
    """The card's published float32 and memory peaks (`peaks.json`), or None
    for a card the table does not hold."""
    with open(_PEAKS) as fh:
        table = json.load(fh)["cards"]
    return table.get(device_name)


@torch.no_grad()
def frame_work(means, cov6, opacity, viewmat, intr, width: int, height: int,
               p: raster.RasterParams, chunk: int = 32) -> dict:
    """{"pairs", "entries", "pixels"} of one frame (see the module docstring)."""
    ts = p.tile_size
    tiles_x, tiles_y = -(-width // ts), -(-height // ts)
    proj = raster.project(means, cov6, viewmat, intr, width, height, p)
    binning = raster.bin_tiles(proj["means2d"], proj["radius"], proj["depth"], proj["valid"],
                               tiles_x, tiles_y, p)
    table = binning["table"]
    op = opacity * proj["valid"].to(opacity.dtype)
    packed = torch.cat([proj["means2d"], proj["conic"], op[:, None]], dim=-1)   # [N, 6]
    filled = table >= 0
    g = packed[torch.where(filled, table, 0)] * filled[..., None].to(packed.dtype)
    origin = raster.tile_origins(tiles_x, tiles_y, ts, means.device)
    K = table.shape[1]
    k = torch.arange(K, device=means.device)
    # Pixels outside the image (a partial last tile) are not part of the frame.
    r = torch.arange(ts, device=means.device)
    py, px = torch.meshgrid(r, r, indexing="ij")
    local = torch.stack([px.reshape(-1), py.reshape(-1)], dim=-1)            # [P, 2]
    pairs = entries = 0
    for s in range(0, table.shape[0], chunk):
        o = origin[s:s + chunk]
        inside = (((o[:, None, 0] + local[None, :, 0]) < width)
                  & ((o[:, None, 1] + local[None, :, 1]) < height))          # [B, P]
        alpha, _ = raster.tile_alpha(o, g[s:s + chunk], filled[s:s + chunk], p)
        alive = (raster.transmittance(alpha) > p.transmittance_min) \
            & filled[s:s + chunk, :, None] & inside[:, None, :]              # [B, K, P]
        pairs += int(torch.sum(alive & (alpha > 0)))
        seen = alive.any(dim=2)                                              # [B, K]
        last = torch.where(seen, k[None, :], -1).amax(dim=1)
        entries += int(torch.sum(last + 1))
    return {"pairs": pairs, "entries": entries, "pixels": width * height}


def forward_cost(work: dict) -> dict:
    """The forward's operations and bytes on a frame's work."""
    return {"ops": work["pairs"] * (OPS_TEST + OPS_VISIBLE_FWD),
            "bytes": work["entries"] * ENTRY_BYTES + work["pixels"] * PIXEL_BYTES}


def backward_cost(work: dict) -> dict:
    """The backward's operations and bytes on a frame's work."""
    return {"ops": work["pairs"] * (OPS_TEST + OPS_VISIBLE_BWD),
            "bytes": 2 * work["entries"] * ENTRY_BYTES + work["pixels"] * PIXEL_BYTES}


def bound_s(cost: dict, card: dict) -> float:
    """The least time the card could take: the larger of the operations at
    its float32 peak and the bytes at its memory bandwidth."""
    return max(cost["ops"] / card["fp32_flops"], cost["bytes"] / card["hbm_bytes_per_s"])
