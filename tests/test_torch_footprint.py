"""The compositor kernels' footprint culling and one-sweep backward, on the CPU.

`raster_cuda.entry_footprints` is the box formula of
`csrc/tile_footprint.cuh` (with its margin) and `thread_pixels` /
`warp_candidates` its warp layout and lists. The kernels only run on the
card, so these tests hold the formula to what the plain twin composites:
no visible pair may fall outside its entry's box or off its warp's list, on
`port_scenes.random_tiles` and on adversarial tiles (pixel centres just
inside, on and just outside the visibility edge; opacity at, just below and
just above alpha_clip; conics that are not positive definite; means off the
tile). The one-sweep backward rests on an identity, checked here with the
twin's chunk math: each pixel's sum of (dL/dw) w equals the cotangents
dotted with the forward's outputs, within 1e-5 of the sum of magnitudes
(f32 sums in two orders).
"""

import os

import numpy as np
import pytest
import torch

from gaussiansplattingregistration_tpu_torch.ops import _build
from gaussiansplattingregistration_tpu_torch.ops import raster_cuda as RC
from gaussiansplattingregistration_tpu_torch.ops.rasterize import RasterizeConfig
from port_scenes import adversarial_tiles, random_tiles, two_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_torch_threads")

CFG = RasterizeConfig()
CLIP32 = np.float32(CFG.alpha_clip)
ADVERSARIAL = {"edge": 0, "threshold": 1, "not_positive_definite": 2, "off_tile": 3}


def tile_set(name):
    """(gT, counts) of a named tile set, 16x16 tiles."""
    rng = np.random.default_rng(7)
    if name.startswith("random"):
        K = int(name.split("_")[1])
        counts = [0, 1, K // 2, K] + list(rng.integers(0, K + 1, 12))
        return random_tiles(rng, counts, K, "cpu")
    if name == "saturating":
        gT, cnt = random_tiles(rng, [384] * 16, 384, "cpu")
        return gT[::4].contiguous(), cnt[::4]
    gT, cnt = adversarial_tiles(rng, (-1e-6, 0.0, 1e-6), "cpu")
    if name == "adversarial":
        return gT, cnt
    kind = ADVERSARIAL[name]
    return gT[4 * kind:4 * kind + 4].contiguous(), cnt[4 * kind:4 * kind + 4]


def visible_pairs(gT, cnt):
    """[T, P, K] pairs the twin composites with alpha > 0 when alive, and
    sigma [T, P, K] (row-major pixels)."""
    T0, _, K = gT.shape
    px, py = RC._pixel_centres(16, gT)
    _, in_count = RC._in_count(cnt, T0, K, gT.device)
    _, _, sigma, _, _, alpha = RC._chunk_terms(gT, px, py, in_count, CFG)
    return alpha > 0, sigma


@pytest.mark.parametrize("name", ["random_384", "random_64", "saturating", *ADVERSARIAL])
def test_footprints_keep_every_visible_pair(name):
    gT, cnt = tile_set(name)
    vis, sigma = visible_pairs(gT, cnt)
    box = RC.entry_footprints(gT, CFG)                                     # [T, 4, K]
    px, py = (c.double() for c in RC._pixel_centres(16, gT))               # [1, P, 1]
    inside = ((box[:, None, 0] <= px) & (px <= box[:, None, 1])
              & (box[:, None, 2] <= py) & (py <= box[:, None, 3]))         # [T, P, K]
    assert not (vis & ~inside).any(), int((vis & ~inside).sum())
    assert not (vis & ~RC.warp_candidates(box, 16)).any()
    assert vis.any()

    g = gT.double()
    op = g[:, 5, None, :].expand_as(sigma)
    mean_off = ((g[:, 0] < 0) | (g[:, 0] > 16) | (g[:, 1] < 0) | (g[:, 1] > 16))[:, None, :]
    det = g[:, 2] * g[:, 4] - g[:, 3] ** 2
    not_pd = ((g[:, 2] <= 0) | (g[:, 4] <= 0) | (det <= 0))[:, None, :]
    if name == "edge":
        # Visible pairs within 1e-5 of the edge sigma = ln(op / alpha_clip).
        edge = torch.log(op / float(CLIP32))
        assert (vis & ((sigma.double() / edge - 1).abs() < 1e-5)).sum() >= 10
    elif name == "threshold":
        assert (vis & (op == float(CLIP32))).any()
        assert not (vis & (op < float(CLIP32))).any()
        assert (gT[:, 5] < torch.tensor(CLIP32)).any()
    elif name == "not_positive_definite":
        assert (vis & not_pd.expand_as(vis)).any() and (sigma < 0).any()
        whole = torch.isinf(box).all(dim=1) & (box[:, 0] < 0)
        assert whole[not_pd[:, 0] & (gT[:, 5] > 0)].all()
    elif name == "off_tile":
        assert (vis & mean_off.expand_as(vis)).sum() >= 100
    elif name.startswith("random"):
        # The boxes cull, though these splats are large (up to 30 px^2
        # variance, every fourth tile 200): a fifth of the pairs at least.
        in_count = RC._in_count(cnt, gT.shape[0], gT.shape[2], gT.device)[1][:, None, :]
        assert (inside & in_count).sum() < 0.8 * in_count.expand_as(inside).sum()


def test_footprint_edge_cases():
    """Empty below alpha_clip, the whole plane for a degenerate or
    non-finite entry, and the ellipse's extents for a diagonal conic."""
    rows = [[3.0, 4.0, 0.5, 0.0, 2.0, 0.9],        # var 2 in x, 0.5 in y
            [3.0, 4.0, 0.5, 0.0, 2.0, 0.003],      # below alpha_clip
            [3.0, 4.0, 1.0, 1.0, 1.0, 0.9],        # det = 0
            [float("nan"), 4.0, 1.0, 0.0, 1.0, 0.9],
            [3.0, 4.0, 1.0, 0.0, 1.0, float("inf")]]
    gT = torch.zeros(1, 10, len(rows))
    gT[0, :6] = torch.tensor(rows).T
    box = RC.entry_footprints(gT, CFG)[0]
    s = np.log(0.9 / float(CLIP32))
    hx, hy = np.sqrt(2 * s / 0.5), np.sqrt(2 * s / 2.0)
    half = np.array([box[1, 0] - 3, 3 - box[0, 0], box[3, 0] - 4, 4 - box[2, 0]])
    np.testing.assert_allclose(half, [hx, hx, hy, hy], rtol=3e-3)
    assert (half > [hx, hx, hy, hy]).all()                       # inflated, not shrunk
    assert box[0, 1] == np.inf and box[1, 1] == -np.inf          # empty
    for k in (2, 3, 4):
        assert box[:, k].tolist() == [-np.inf, np.inf, -np.inf, np.inf]


@pytest.mark.parametrize("ts", [16, 8, 32, 12, 5])
def test_warp_layout(ts):
    """Every pixel is held by one thread; with ts a multiple of 8 each warp
    is an 8x4 block, otherwise a row-major run."""
    tp = RC.thread_pixels(ts)
    P = ts * ts
    assert len(tp) % 32 == 0 and len(tp) - P < 32
    assert sorted(tp[tp >= 0].tolist()) == list(range(P)) and (tp[P:] == -1).all()
    for w in range(len(tp) // 32):
        p = tp[32 * w:32 * w + 32]
        p = p[p >= 0]
        x, y = p % ts, p // ts
        if ts % 8 == 0:
            assert (x.max() - x.min(), y.max() - y.min()) == (7, 3)
            assert x.min() % 8 == 0 and y.min() % 4 == 0
        else:
            assert p.tolist() == list(range(32 * w, min(32 * w + 32, P)))


def pixel_sums(gT, cnt, g_rgb, g_alpha, g_depth):
    """Per pixel sum_k (dL/dw_k) w_k and sum_k |(dL/dw_k) w_k|, in the bwd
    twin's chunk math (its first sweep)."""
    T0, _, K = gT.shape
    px, py = RC._pixel_centres(16, gT)
    _, in_count = RC._in_count(cnt, T0, K, gT.device)
    G5 = torch.cat([g_rgb, g_depth[..., None], g_alpha[..., None]], dim=-1)
    carry = torch.ones(T0, 256)
    total, magnitude = torch.zeros(T0, 256), torch.zeros(T0, 256)
    for c0 in range(0, K, RC._CHUNK):
        pc = gT[:, :, c0:c0 + RC._CHUNK]
        alpha = RC._chunk_terms(pc, px, py, in_count[:, c0:c0 + RC._CHUNK], CFG)[5]
        lt = torch.log1p(-alpha)
        cum = torch.cumsum(lt, dim=2)
        T = carry[:, :, None] * torch.exp(cum - lt)
        w = torch.where(T > CFG.transmittance_min, alpha * T, 0.0)
        terms = torch.einsum("tpv,tvs->tps", G5, RC._value_rows(pc)) * w
        total, magnitude = total + terms.sum(2), magnitude + terms.abs().sum(2)
        carry = carry * torch.exp(cum[:, :, -1])
    return total, magnitude


@pytest.mark.parametrize("name", ["random_384", "random_64", "saturating", "adversarial"])
def test_pixel_total_equals_cotangents_dot_outputs(name):
    """The one-sweep backward's premise: sum_j (dL/dw_j) w_j = g_rgb . rgb
    + g_depth depth + g_alpha alpha of the forward's outputs."""
    gT, cnt = tile_set(name)
    rng = np.random.default_rng(3)
    g_rgb, g_a, g_d = (torch.tensor(rng.normal(size=s), dtype=torch.float32)
                       for s in ((gT.shape[0], 256, 3), (gT.shape[0], 256), (gT.shape[0], 256)))
    rgb, alpha, depth, _ = RC.composite_tiles_reference(gT, cnt, 16, CFG)
    dotted = (g_rgb * rgb).sum(-1) + g_d * depth + g_a * alpha
    total, magnitude = pixel_sums(gT, cnt, g_rgb, g_a, g_d)
    scale = float(magnitude.max())
    assert scale > 0
    assert float((total - dotted).abs().max()) <= 1e-5 * scale


def test_composite_saves_outputs_for_the_backward():
    """The autograd residuals are (gT, counts) and the four outputs, and the
    backward through them is the twin's VJP."""
    gT, cnt = tile_set("random_64")
    x = gT.clone().requires_grad_(True)
    out = RC.composite_tiles(x, cnt, 16, CFG)
    saved = out[0].grad_fn.saved_tensors
    assert len(saved) == 6
    for a, b in zip(saved[2:], out):
        assert torch.equal(a, b.detach())
    g = [torch.ones_like(o) for o in out[:3]]
    (d_x,) = torch.autograd.grad(out[:3], x, g)
    assert torch.equal(d_x, RC.composite_tiles_reference_bwd(gT, cnt, *g, 16, CFG))


@pytest.mark.parametrize("name", ["random_64", "adversarial"])
def test_footprint_boxes_round_outward_to_f32(name):
    """The f32 boxes (the header rounds its f64 edges outward) hold the f64
    ones and lie within one f32 step of them; infinite edges stay as they
    are. The card's boxes are held to these in
    tests/test_torch_composite_kernels.py."""
    gT, _ = tile_set(name)
    exact = RC.entry_footprints(gT, CFG)
    boxes = RC.footprint_boxes(gT, CFG)
    assert boxes.dtype == torch.float32 and boxes.shape == exact.shape
    b = boxes.double()
    assert (b[:, 0::2] <= exact[:, 0::2]).all() and (b[:, 1::2] >= exact[:, 1::2]).all()
    finite = torch.isfinite(exact)
    assert torch.equal(torch.isfinite(boxes), finite)
    assert torch.equal(b[~finite], exact[~finite])
    step = torch.from_numpy(np.spacing(np.abs(boxes.numpy()))).double()
    assert ((b - exact).abs()[finite] <= step[finite]).all()
    assert finite.any()


def test_build_target_hashes_shared_headers(tmp_path, monkeypatch):
    """An edited header gives every kernel a new library name, so a stale
    build is never reused; the same tree gives the same name."""
    for name, text in (("k.cu", '#include "shared.cuh"\n'), ("shared.cuh", "// v1\n")):
        (tmp_path / name).write_text(text)
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    before = _build._target("k")
    assert _build._target("k") == before
    (tmp_path / "shared.cuh").write_text("// v2\n")
    after = _build._target("k")
    assert after != before and os.path.dirname(after) == _build.BUILD_DIR
