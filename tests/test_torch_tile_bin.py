"""The tile table's binning: the plain form's counters on the CPU, and the
kernels of `csrc/tile_bin.cu` (`rasterize.tile_bin`) against the plain form
on the card.

The card tests are marked `card` and skip without a CUDA card. On the
card's machine, from the repo root, with the other kernels' card tests:

    python -m pytest --noconftest tests/test_torch_tile_bin.py tests/test_torch_composite_kernels.py tests/test_torch_knn_kernel.py -m card -q

This file imports no JAX and takes nothing from `conftest.py`, so that it
runs there without either.
"""

import math

import numpy as np
import pytest
import torch

from gaussiansplattingregistration_tpu_torch.ops import rasterize as R
from gaussiansplattingregistration_tpu_torch.utils import profiling
from port_scenes import tile_bin_cells, tile_bin_compare, two_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_torch_threads")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card's machine)")
    return torch.device("cuda")


def bin_inputs(seed, n, width, height, *, radius_max=40.0, valid_share=0.85,
               equal_depth=False, device="cpu"):
    """(means2d, radius, depth, valid) of `n` splats scattered over and
    around a `width` x `height` image, as numpy-drawn float32 tensors."""
    rng = np.random.default_rng(seed)
    means2d = rng.uniform(-20, [width + 20, height + 20], size=(n, 2)).astype(np.float32)
    valid = rng.uniform(size=n) < valid_share
    radius = np.where(valid, np.ceil(rng.uniform(0, radius_max, size=n)), 0).astype(np.float32)
    depth = (np.full(n, 2.0, np.float32) if equal_depth
             else rng.uniform(0.5, 5.0, size=n).astype(np.float32))
    return tuple(torch.as_tensor(a, device=device) for a in (means2d, radius, depth, valid))


def hand_entries(means2d, radius, valid, tiles_x, tiles_y, C, ty_offset=0, window=None,
                 ts=16):
    """The entries of the table counted splat by splat in numpy float32:
    each valid splat's clamped tile rectangle, clipped to the centred
    window of C tiles, within the slab's rows."""
    window = tiles_y if window is None else window
    side = max(1, math.isqrt(C))

    def tile(v, hi):
        return int(min(max(np.floor(np.float32(v) / np.float32(ts)), 0), hi))

    total = 0
    for (mx, my), r, ok in zip(means2d.numpy(), radius.numpy(), valid.numpy()):
        if not ok:
            continue
        tx0, ty0 = tile(mx - r, tiles_x - 1), tile(my - r, tiles_y - 1)
        w = tile(mx + r, tiles_x - 1) - tx0 + 1
        h = tile(my + r, tiles_y - 1) - ty0 + 1
        top, rows, cols = ty0, h, w
        if w * h > C:
            cols = min(w, side)
            rows = min(h, C // cols)
            top = ty0 + min(max(tile(my, tiles_y - 1) - ty0 - (rows - 1) // 2, 0), h - rows)
        total += cols * sum(ty_offset <= y < ty_offset + window for y in range(top, top + rows))
    return total


CPU_CASES = {
    "c16": dict(C=16, kw={}),
    "slab": dict(C=16, kw={"ty_offset": 1, "tiles_y_window": 2}),
    "clipped_at_c": dict(C=4, kw={}, radius_max=120.0),
    "c1": dict(C=1, kw={}),
    "no_valid": dict(C=16, kw={}, valid_share=0.0),
}


@pytest.mark.parametrize("case", sorted(CPU_CASES))
def test_plain_form_counts_entries_and_slots(case):
    """While tracing is on, the plain form adds the entries it keeps to
    `raster.bin_entries` and N·C to `raster.bin_slots`; off, it adds none."""
    spec = CPU_CASES[case]
    W, H, n = 96, 64, 150
    args = bin_inputs(7, n, W, H, radius_max=spec.get("radius_max", 40.0),
                      valid_share=spec.get("valid_share", 0.85))
    cfg = R.RasterizeConfig(max_tiles_per_splat=spec["C"], max_splats_per_tile=24)
    profiling.reset()
    R._build_tile_table(*args, W // 16, H // 16, cfg, **spec["kw"])
    assert profiling.snapshot()["counters"] == {}
    with profiling.recording():
        *_, stats = R._build_tile_table(*args, W // 16, H // 16, cfg, with_stats=True,
                                        **spec["kw"])
    counters = profiling.snapshot()["counters"]
    want = hand_entries(args[0], args[1], args[3], W // 16, H // 16, spec["C"],
                        spec["kw"].get("ty_offset", 0), spec["kw"].get("tiles_y_window"))
    assert counters == {"raster.bin_entries": want, "raster.bin_slots": n * spec["C"]}
    assert int(stats["total_entries"]) == want
    if case == "clipped_at_c":
        assert int(stats["coverage_clipped_splats"]) > 0
    if case == "no_valid":
        assert want == 0


def test_cpu_tensors_take_the_plain_form_and_tile_bin_refuses_them():
    args = bin_inputs(3, 40, 64, 48)
    cfg = R.RasterizeConfig(max_tiles_per_splat=4, max_splats_per_tile=16)
    before = R.tile_bin.launches
    got = R._build_tile_table(*args, 4, 3, cfg)
    want = R._build_tile_table_plain(*args, 4, 3, cfg)
    for g, w in zip(got[:5], want[:5]):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="CUDA tensors"):
        R.tile_bin(*args, 4, 3, cfg)
    assert R.tile_bin.launches == before


# ------------------------------------------------------------------ card


def assert_same_table(got, want):
    """The kernel path's outputs against the plain form's
    (`port_scenes.tile_bin_compare`): table, counts, order and counters
    equal; sorted entries equal the plain form's first E, past which the
    plain form holds only empty slots; no live flags."""
    rec = tile_bin_compare(got, want)
    assert rec["equal"], rec
    assert rec["stats"]["total_entries"] == rec["entries"]
    assert all(v.dtype == torch.int32 for v in got[5].values())
    assert got[2] is None


CARD_CASES = {
    # a slab of rows: slab-local tile ids, the whole image's key bits
    "slab": dict(n=20_000, size=(640, 480), C=16, K=64,
                 kw={"ty_offset": 7, "tiles_y_window": 11}),
    # dense splats on a small image: runs longer than K are cut at K
    "run_over_k": dict(n=50_000, size=(256, 256), C=16, K=32, kw={}),
    # large radii at C=4: windows clipped to the centred 2 x 2 tiles
    "clipped_at_c": dict(n=20_000, size=(640, 480), C=4, K=256, kw={}, radius_max=200.0),
    # every depth equal: every key of a tile ties, so entry-id order decides
    "equal_depths": dict(n=30_000, size=(512, 512), C=9, K=4096, kw={}, equal_depth=True),
    # no valid splat: no entry is emitted or sorted
    "no_valid": dict(n=10_000, size=(640, 480), C=16, K=64, kw={}, valid_share=0.0),
    # image-ordered rows (order None); a backward cap below K leaves the table
    "torch_backend_bwd_cap": dict(n=20_000, size=(640, 480), C=16, K=64, kw={},
                                  backend="torch", bwd_cap=9),
}


@pytest.mark.card
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_tile_bin_matches_plain_form_on_card(card, case):
    spec = CARD_CASES[case]
    W, H = spec["size"]
    args = bin_inputs(11, spec["n"], W, H, radius_max=spec.get("radius_max", 40.0),
                      valid_share=spec.get("valid_share", 0.85),
                      equal_depth=spec.get("equal_depth", False), device=card)
    cfg = R.RasterizeConfig(max_tiles_per_splat=spec["C"], max_splats_per_tile=spec["K"],
                            backend=spec.get("backend", "cuda"),
                            max_bwd_splats_per_tile=spec.get("bwd_cap"))
    tiles_x, tiles_y = -(-W // 16), -(-H // 16)
    before = R.tile_bin.launches
    got = R._build_tile_table(*args, tiles_x, tiles_y, cfg, with_stats=True, **spec["kw"])
    assert R.tile_bin.launches == before + 1
    want = R._build_tile_table_plain(*args, tiles_x, tiles_y, cfg, with_stats=True,
                                     **spec["kw"])
    torch.cuda.synchronize()
    assert_same_table(got, want)
    stats = {k: int(v) for k, v in got[5].items()}
    if case == "run_over_k":
        assert stats["overflow_tiles"] > 0 and stats["dropped_entries"] > 0
    if case == "clipped_at_c":
        assert stats["coverage_clipped_splats"] > 0
    if case == "equal_depths":
        assert stats["max_run"] > 1
    if case == "no_valid":
        assert got[1].numel() == 0 and stats["total_entries"] == 0
        assert bool((got[0] == -1).all())
    if case == "torch_backend_bwd_cap":
        assert got[4] is None and not bool(want[2].all())


@pytest.fixture(scope="module")
def cell_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card's machine)")
    return tile_bin_cells(torch.device("cuda"))


@pytest.mark.card
@pytest.mark.parametrize("cell", ["photo_pair_step_view", "splat1m_frame", "bench_config",
                                  "viewer_default", "sharded_step_camera1", "config5"])
def test_tile_bin_matches_plain_form_at_cell_shapes(cell_inputs, cell):
    """One view of `photo_pair_step` (2.2M splats, C=36, K=3072, 1557x1038,
    partial tiles), one frame of the 720p cells (C=4, K=512,
    `max_live_tiles` 2688), and the frames of `chip_smoke.py`'s main paths
    (the bench frame at K=384, the viewer's default view at C=16, K=256,
    the sharded train step's second camera, config 5's at 640x360), with
    the counters of the traced run."""
    _, args, tiles_x, tiles_y, cfg = next(c for c in cell_inputs if c[0] == cell)
    before = R.tile_bin.launches
    profiling.reset()
    with profiling.recording():
        got = R._build_tile_table(*args, tiles_x, tiles_y, cfg, with_stats=True)
    counters = profiling.snapshot()["counters"]
    assert R.tile_bin.launches == before + 1
    want = R._build_tile_table_plain(*args, tiles_x, tiles_y, cfg, with_stats=True)
    torch.cuda.synchronize()
    assert_same_table(got, want)
    n, C = args[0].shape[0], cfg.max_tiles_per_splat
    assert counters == {"raster.bin_entries": got[1].numel(), "raster.bin_slots": n * C}
    assert got[1].numel() > 0


@pytest.mark.card
def test_rasterizer_main_path_launches_tile_bin(card):
    from gaussiansplattingregistration_tpu_torch.ops import raster_cuda

    g = torch.Generator(device=card)
    g.manual_seed(5)
    n = 4000
    means = torch.rand((n, 3), generator=g, device=card) * 2 - 1
    cov = torch.zeros((n, 6), device=card)
    cov[:, [0, 3, 5]] = 1e-3
    opacity = torch.full((n,), 0.5, device=card)
    features = torch.rand((n, 1, 3), generator=g, device=card)
    f = 200.0
    viewmat = torch.eye(4, device=card)
    viewmat[2, 3] = 3.0
    intr = torch.tensor([[f, 0, 160.0], [0, f, 120.0], [0, 0, 1]], device=card)
    bins, fwd = R.tile_bin.launches, raster_cuda.composite_tiles.launches
    rgb, alpha, _ = R.rasterize_arrays(means, cov, opacity, features, viewmat, intr, 320, 240,
                                       0, torch.zeros(3, device=card), device=card)
    torch.cuda.synchronize()
    assert R.tile_bin.launches == bins + 1
    assert raster_cuda.composite_tiles.launches == fwd + 1
    assert float(alpha.max()) > 0
