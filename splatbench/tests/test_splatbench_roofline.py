"""The compositor's work count (`roofline/composite.py`) equals a brute
per-pixel count on a tiny scene, and at one frame the visible pairs of the
port's own count over its kernel layout (`chip_smoke.pair_counts`)."""

from __future__ import annotations

import dataclasses
import math

import pytest
import torch

from splatbench import scenes
from splatbench.reference import raster
from splatbench.roofline import composite

SPEC = {"draw": "uniform", "splats": 400, "sh_degree": 0, "xyz_range": [-1.0, 1.0],
        "scale_range": [0.03, 0.09], "dc_std": 0.3, "rest_std": 0.1, "opacity_logit_std": 1.5}
W, H = 48, 32
P = raster.RasterParams(max_tiles_per_splat=4, max_splats_per_tile=24)


def _frame(seed):
    means, cov6, opacity, _ = scenes.splat_scene(SPEC, seed, "cpu")
    vm, intr = raster.camera(0.2, W, H, 70.0, 3.0, "cpu")
    return means, cov6, opacity, vm, intr


def _brute(means, cov6, opacity, vm, intr):
    """Pixel by pixel, entry by entry, in the table's order."""
    ts = P.tile_size
    tx, ty = -(-W // ts), -(-H // ts)
    proj = raster.project(means, cov6, vm, intr, W, H, P)
    table = raster.bin_tiles(proj["means2d"], proj["radius"], proj["depth"], proj["valid"],
                             tx, ty, P)["table"]
    m2, co = proj["means2d"], proj["conic"]
    op = opacity * proj["valid"].float()
    pairs = entries = 0
    for t in range(tx * ty):
        ox, oy = (t % tx) * ts, (t // tx) * ts
        ids = [int(i) for i in table[t] if i >= 0]
        last = -1
        for py in range(ts):
            for px in range(ts):
                x = torch.tensor(ox + px + 0.5)
                y = torch.tensor(oy + py + 0.5)
                log_t = torch.tensor(0.0)
                for k, s in enumerate(ids):
                    dx, dy = x - m2[s, 0], y - m2[s, 1]
                    sigma = 0.5 * (co[s, 0] * dx * dx + co[s, 2] * dy * dy) + co[s, 1] * dx * dy
                    a = torch.clamp_max(op[s] * torch.exp(-torch.clamp_min(sigma, 0.0)),
                                        P.alpha_max)
                    if not (a >= P.alpha_clip and sigma >= 0.0):
                        a = torch.tensor(0.0)
                    if math.exp(float(log_t)) > P.transmittance_min:
                        last = max(last, k)
                        pairs += int(a > 0)
                    log_t = log_t + torch.log1p(-a)
        entries += last + 1
    return pairs, entries


@pytest.mark.parametrize("seed", [5, 3_000_000_007])
def test_counts_equal_a_brute_per_pixel_count(seed):
    frame = _frame(seed)
    work = composite.frame_work(*frame, W, H, P)
    pairs, entries = _brute(*frame)
    assert work["pixels"] == W * H
    assert pairs > 0
    assert (work["pairs"], work["entries"]) == (pairs, entries)


def test_visible_pairs_equal_the_port_count_over_its_layout():
    import chip_smoke
    from gaussiansplattingregistration_tpu_torch.ops import rasterize as R

    means, cov6, opacity, vm, intr = _frame(11)
    cfg = R.RasterizeConfig(max_tiles_per_splat=P.max_tiles_per_splat,
                            max_splats_per_tile=P.max_splats_per_tile, backend="cuda")
    feats = torch.zeros((means.shape[0], 1, 3))
    args = (means, cov6, opacity, feats, vm, intr, W, H, 0, torch.zeros(3))
    x = chip_smoke.kernel_inputs(args, cfg)
    theirs = chip_smoke.pair_counts(x["gT"], x["cnt"], cfg.tile_size, cfg)
    ours = composite.frame_work(means, cov6, opacity, vm, intr, W, H, P)
    assert ours["pairs"] == theirs["visible"]


def test_costs_charge_the_frozen_constants():
    w = {"pairs": 10, "entries": 3, "pixels": 4}
    assert composite.forward_cost(w) == {"ops": 300, "bytes": 3 * 40 + 4 * 20}
    assert composite.backward_cost(w) == {"ops": 730, "bytes": 2 * 3 * 40 + 4 * 20}
    card = composite.peaks("NVIDIA H100 80GB HBM3")
    assert card == {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}
    assert composite.bound_s({"ops": 67e12, "bytes": 0}, card) == 1.0
    assert composite.peaks("some other card") is None
    assert dataclasses.is_dataclass(P)
