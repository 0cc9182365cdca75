"""The composite kernels (`csrc/composite_fwd.cu`, `csrc/composite_bwd.cu`)
against their plain twins on the card, and the culling boxes the card
computes (`csrc/tile_footprint.cuh`) against their plain formula.

The tests are marked `card` and skip without a CUDA card. On the card's
machine, from the repo root, with the other kernels' card tests:

    python -m pytest --noconftest tests/test_torch_tile_bin.py tests/test_torch_composite_kernels.py tests/test_torch_knn_kernel.py -m card -q

This file imports no JAX and takes nothing from `conftest.py`, so that it
runs there without either.
"""

import numpy as np
import pytest
import torch

from gaussiansplattingregistration_tpu_torch.ops import raster_cuda as RC
from gaussiansplattingregistration_tpu_torch.ops.rasterize import RasterizeConfig
from port_scenes import (
    adversarial_tiles,
    check_bwd,
    max_errs,
    pair_counts,
    random_tiles,
    two_torch_threads,  # noqa: F401
)

pytestmark = pytest.mark.usefixtures("two_torch_threads")

CFG = RasterizeConfig()
SETS = ["seeded_k384", "seeded_k64", "adversarial"]


@pytest.fixture(scope="module")
def tile_sets():
    """{name: (gT, counts, cotangents)} on the card, drawn from one
    default_rng(0) in this order: the seeded sets at K = 384 and K = 64
    (counts at the chunk edges, then random; every fourth tile saturates),
    adversarial tiles whose boundary pairs sit 1e-3 inside and outside the
    visibility edge (so that f32 rounding on the card and on the host
    cannot flip them), then each set's seeded cotangents."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card's machine)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    sets = []
    for K, fixed in ((384, [0, 1, 127, 128, 129, 384]), (64, [0, 1, 63, 64])):
        counts = fixed + list(rng.integers(0, K + 1, 64 - len(fixed)))
        sets.append(random_tiles(rng, counts, K, dev))
    sets.append(adversarial_tiles(rng, (-1e-3, 1e-3), dev))
    out = {}
    for name, (gT, cnt) in zip(SETS, sets):
        T0 = gT.shape[0]
        cts = [torch.tensor(rng.normal(size=s), dtype=torch.float32, device=dev)
               for s in ((T0, 256, 3), (T0, 256), (T0, 256))]
        out[name] = (gT, cnt, cts)
    return out


@pytest.mark.card
@pytest.mark.parametrize("name", SETS)
def test_composite_fwd_matches_twin(tile_sets, name):
    """rgb and alpha within 1e-5, depth within 1e-4 (depths reach 5),
    `live` exactly: the kernel keeps T as a running product, the twin as
    exp(cumsum(log1p(-alpha))), so they differ by rounding only."""
    gT, cnt, _ = tile_sets[name]
    got = RC.composite_tiles(gT, cnt, 16, CFG)
    torch.cuda.synchronize()
    want = RC.composite_tiles_reference(gT, cnt, 16, CFG)
    errs, live_eq = max_errs(got, want)
    assert errs[0] <= 1e-5 and errs[1] <= 1e-5 and errs[2] <= 1e-4, errs
    assert live_eq


@pytest.mark.card
@pytest.mark.parametrize("name", SETS)
def test_composite_bwd_matches_twin(tile_sets, name):
    """From the forward kernel's outputs, on seeded cotangents: within 1e-3
    of each channel's max in the twin and finite (`check_bwd`), zero past
    each tile's count, and a second launch gives the same bits. The seeded
    sets reach the alpha_max clamp."""
    gT, cnt, cts = tile_sets[name]
    got = RC.composite_tiles(gT, cnt, 16, CFG)
    d_got = RC.composite_tiles_bwd(gT, cnt, *cts, 16, CFG, fwd_out=got)
    d_again = RC.composite_tiles_bwd(gT, cnt, *cts, 16, CFG, fwd_out=got)
    torch.cuda.synchronize()
    d_want = RC.composite_tiles_reference_bwd(gT, cnt, *cts, 16, CFG)
    check_bwd(d_got, d_want, name)
    for t, c in enumerate(cnt[:, 0].long().tolist()):
        assert bool((d_got[t, :, c:] == 0).all()), f"nonzero gradient past tile {t}'s count"
    assert torch.equal(d_got, d_again)
    if name.startswith("seeded"):
        assert pair_counts(gT, cnt, 16, CFG)["clamped"] > 0


@pytest.mark.card
def test_footprint_boxes_on_card_match_formula():
    """The culling boxes the card computes (read back through
    `raster_cuda.footprint_boxes`) on adversarial tiles whose boundary
    pixels sit 1e-6 inside, on and 1e-6 outside the visibility edge: equal
    to the plain formula's boxes rounded outward to f32 within one f32 step
    (the margin is ~1e-3 of an extent, so a header without it is caught),
    with the same infinite edges; and every pair the twin's math on the
    card finds visible inside its entry's box and on its warp's list, with
    some of them within 1e-5 of the edge."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card's machine)")
    dev = torch.device("cuda")
    gT, cnt = adversarial_tiles(np.random.default_rng(5), (-1e-6, 0.0, 1e-6), dev)
    card = RC.footprint_boxes(gT, CFG)
    torch.cuda.synchronize()
    want = RC.footprint_boxes(gT.cpu(), CFG)
    got = card.cpu()
    finite = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), finite)
    assert torch.equal(got[~finite], want[~finite])
    step = torch.from_numpy(np.spacing(np.abs(want.numpy()))).double()
    steps_off = float(((got.double() - want.double()).abs() / step)[finite].max())
    assert steps_off <= 1.0, steps_off
    px, py = RC._pixel_centres(16, gT)
    _, in_count = RC._in_count(cnt, gT.shape[0], gT.shape[2], dev)
    _, _, sigma, _, _, alpha = RC._chunk_terms(gT, px, py, in_count, CFG)
    vis = alpha > 0
    b = card.double()
    inside = ((b[:, None, 0] <= px) & (px <= b[:, None, 1])
              & (b[:, None, 2] <= py) & (py <= b[:, None, 3]))
    assert int((vis & ~inside).sum()) == 0
    assert int((vis & ~RC.warp_candidates(b, 16)).sum()) == 0
    edge = torch.log(gT[:, None, 5, :].double() / float(np.float32(CFG.alpha_clip)))
    assert int((vis & ((sigma.double() / edge - 1).abs() < 1e-5)).sum()) > 0
