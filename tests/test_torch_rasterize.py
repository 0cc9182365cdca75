"""Torch port vs JAX package: the compositor, the tile table, the config,
and empty or culled scenes (rendered parity: test_torch_rasterize_render.py).

The same seeded numpy inputs go through both packages on the CPU. The JAX
side runs as its own tests run it (`raster_pallas` in interpret mode); the
port runs with device="cpu", so `composite_tiles` takes its plain twin.
Backend pairs: port "cuda" <-> JAX "pallas", port "torch" <-> JAX "xla".

Tolerances: rgb and alpha atol 1e-5, depth atol 1e-4 (f32 sums in another
order; depths are ~4, so the same relative error is 10x larger); the tile
table, the live horizon and the integer stats exactly.
"""

import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gaussiansplattingregistration_tpu.ops import raster_pallas
from gaussiansplattingregistration_tpu.ops import rasterize as JR
from gaussiansplattingregistration_tpu_torch.ops import raster_cuda
from gaussiansplattingregistration_tpu_torch.ops import rasterize as TR
from tests.test_rasterize import HEIGHT, WIDTH, make_camera, make_scene
from port_scenes import random_tiles as scene_tiles, two_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_torch_threads")

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
JAX_BACKEND = {"cuda": "pallas", "torch": "xla"}


def jax_config(cfg: TR.RasterizeConfig) -> JR.RasterizeConfig:
    fields = dataclasses.asdict(cfg)
    fields["backend"] = JAX_BACKEND[cfg.backend]
    return JR.RasterizeConfig(**fields)


def scene_arrays(cloud, cam):
    """The rasterize_arrays inputs of a JAX cloud and camera, as numpy."""
    return (np.asarray(cloud.xyz), np.asarray(cloud.get_covariance()),
            np.asarray(cloud.get_opacity[:, 0]), np.asarray(cloud.get_features),
            np.asarray(cam.viewmat), np.asarray(cam.intrinsics),
            cam.width, cam.height, cloud.sh_degree)


def render_both(arrays, bg, cfg, with_stats=False):
    *data, w, h, deg = arrays
    bg = np.asarray(bg, np.float32)
    if with_stats:
        got = TR.rasterize_arrays_with_stats(*data, w, h, deg, bg, cfg, device="cpu")
        want = JR.rasterize_arrays_with_stats(*map(jnp.asarray, data), w, h, deg,
                                              jnp.asarray(bg), jax_config(cfg))
    else:
        got = TR.rasterize_arrays(*data, w, h, deg, bg, cfg, device="cpu")
        want = JR.rasterize_arrays(*map(jnp.asarray, data), w, h, deg,
                                   jnp.asarray(bg), jax_config(cfg))
    return got, want


def assert_images_close(got, want):
    for g, w, atol, name in zip(got[:3], want[:3], (1e-5, 1e-5, 1e-4),
                                ("rgb", "alpha", "depth")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, err_msg=name)


def assert_stats_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if k == "mean_live":
            # Same integer sum; XLA's mean may round the division 1 ulp apart.
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)
        else:
            assert int(got[k]) == int(want[k]), (k, int(got[k]), int(want[k]))


# ------------------------------------------------------------------ config

def test_config_fields_match_jax():
    port = {f.name: f.default for f in dataclasses.fields(TR.RasterizeConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JR.RasterizeConfig)}
    assert port.pop("backend") == "cuda" and ref.pop("backend") == "xla"
    assert port == ref
    cfg = TR.RasterizeConfig(max_live_tiles=8)
    assert hash(cfg) == hash(TR.RasterizeConfig(max_live_tiles=8))
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.backend = "torch"
    with pytest.raises(ValueError, match="backend"):
        TR.RasterizeConfig(backend="pallas")


# -------------------------------------------------- (a) compositor vs JAX

def random_tiles(rng, counts, K):
    """port_scenes' seeded tiles (zero past counts; every fourth tile
    saturates) as numpy."""
    gT, cnt = scene_tiles(rng, counts, K, "cpu")
    return gT.numpy(), cnt.numpy()


@pytest.mark.parametrize("K,fixed", [(384, [0, 1, 127, 128, 129, 384]),
                                     (64, [0, 1, 63, 64])])
def test_composite_reference_matches_pallas(rng, K, fixed):
    counts = fixed + list(rng.integers(0, K + 1, 24 - len(fixed)))
    gT, cnt = random_tiles(rng, counts, K)
    cfg = TR.RasterizeConfig()
    got = raster_cuda.composite_tiles_reference(torch.as_tensor(gT), torch.as_tensor(cnt), 16, cfg)
    want = raster_pallas.composite_tiles_pallas(jnp.asarray(gT), jnp.asarray(cnt), 16,
                                                jax_config(cfg))
    assert_images_close(got, want)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    # The horizon is 128-granular even past K, and some tiles saturate early.
    live = got[3].numpy()
    assert (live % 128 == 0).all()
    if K == 64:
        assert live.max() == 128
    else:
        assert (live < np.ceil(np.asarray(counts) / 128) * 128).any()


def test_composite_tiles_wrapper_on_cpu(rng):
    """On a CPU tensor the wrapper runs the twins, forward and backward, and
    launches nothing; the launchers refuse a CPU tensor."""
    gT, cnt = random_tiles(rng, [5, 64, 0, 30, 12, 1, 64, 7], 64)
    gT = torch.as_tensor(gT, dtype=torch.float32).requires_grad_(True)
    cnt = torch.as_tensor(cnt)
    cfg = TR.RasterizeConfig()
    before = (raster_cuda.composite_tiles.launches, raster_cuda.composite_tiles_bwd.launches)
    out = raster_cuda.composite_tiles(gT, cnt, 16, cfg)
    ref = raster_cuda.composite_tiles_reference(gT.detach(), cnt, 16, cfg)
    for a, b in zip(out, ref):
        assert torch.equal(a.detach(), b)
    g_rgb = torch.as_tensor(rng.normal(size=out[0].shape), dtype=torch.float32)
    (d_gT,) = torch.autograd.grad((out[0] * g_rgb).sum(), gT)
    zeros = torch.zeros(out[1].shape)
    assert torch.equal(d_gT, raster_cuda.composite_tiles_reference_bwd(
        gT.detach(), cnt, g_rgb, zeros, zeros, 16, cfg))
    assert (raster_cuda.composite_tiles.launches,
            raster_cuda.composite_tiles_bwd.launches) == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        raster_cuda._launch(gT.detach(), cnt, 16, cfg)
    with pytest.raises(ValueError, match="CUDA tensor"):
        raster_cuda._launch_bwd(gT.detach(), cnt, g_rgb, zeros, zeros, 16, cfg, out)


# ----------------------------------------------------- (b) tile table

def table_inputs(rng, n, width, height, near_equal_depth=False):
    means2d = rng.uniform(-20, width + 20, size=(n, 2)).astype(np.float32)
    radius = np.ceil(rng.uniform(0, 40, size=n)).astype(np.float32)
    valid = rng.uniform(size=n) > 0.15
    radius = np.where(valid, radius, 0.0).astype(np.float32)
    if near_equal_depth:
        # Depths within a few ulps: the quantized keys collide, so ties
        # must break by entry id as in the JAX package.
        depth = (np.float32(2.0) + np.float32(2.0 ** -22) * rng.integers(0, 4, n)).astype(np.float32)
    else:
        depth = rng.uniform(0.5, 5.0, size=n).astype(np.float32)
    return means2d, radius, depth, valid


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("case", ["C1", "C4", "C16_bwdcap", "near_equal_depth", "slab"])
def test_tile_table_matches_jax_exactly(rng, backend, case):
    C = {"C1": 1, "C4": 4}.get(case, 16)
    cfg = TR.RasterizeConfig(max_tiles_per_splat=C, max_splats_per_tile=24, backend=backend,
                             max_bwd_splats_per_tile=5 if case == "C16_bwdcap" else None)
    W, H = 96, 64
    means2d, radius, depth, valid = table_inputs(rng, 120, W, H, case == "near_equal_depth")
    kw = {"ty_offset": 1, "tiles_y_window": 2} if case == "slab" else {}
    got = TR._build_tile_table(torch.as_tensor(means2d), torch.as_tensor(radius),
                               torch.as_tensor(depth), torch.as_tensor(valid),
                               W // 16, H // 16, cfg, with_stats=True, **kw)
    want = JR._build_tile_table(jnp.asarray(means2d), jnp.asarray(radius), jnp.asarray(depth),
                                jnp.asarray(valid), W // 16, H // 16, jax_config(cfg),
                                with_stats=True, **kw)
    for name, g, w in zip(("table", "sorted_entry", "live", "counts"), got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    if backend == "cuda":
        np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    else:
        assert got[4] is None and want[4] is None
    assert_stats_equal(got[5], want[5])
    table = got[0].numpy()
    assert (table >= 0).sum() > 0
    if case == "near_equal_depth":
        # Collisions really happen: some tile keeps equal-key entries.
        d = np.where(table >= 0, depth[np.maximum(table, 0) // C], np.nan)
        assert any(len(set(row[~np.isnan(row)])) < (~np.isnan(row)).sum() for row in d)


# ------------------------------------------------- (f) empty and culled

XLA_CFG = TR.RasterizeConfig(max_tiles_per_splat=16, max_splats_per_tile=64,
                             tile_chunk=4, backend="torch")


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_empty_scene_renders_background(rng, backend):
    cloud = make_scene(rng, n=4)
    cloud = dataclasses.replace(cloud, xyz=cloud.xyz + jnp.asarray([0.0, 0.0, 100.0]))
    *data, w, h, deg = scene_arrays(cloud, make_camera())
    bg = (0.25, 0.5, 0.75)
    rgb, alpha, depth = TR.rasterize_arrays(*data, w, h, deg, bg,
                                            dataclasses.replace(XLA_CFG, backend=backend),
                                            device="cpu")
    np.testing.assert_allclose(rgb.numpy(), np.broadcast_to(bg, (HEIGHT, WIDTH, 3)), atol=1e-6)
    np.testing.assert_allclose(alpha.numpy(), 0.0, atol=1e-6)


def test_behind_camera_splats_are_culled():
    cam = make_camera()
    cov = torch.tensor([[0.01, 0, 0, 0.01, 0, 0.01]] * 2)
    proj = TR.project_gaussians(torch.tensor([[0.0, 0.0, -10.0], [0.0, 0.0, 0.0]]), cov,
                                torch.tensor(np.asarray(cam.viewmat)),
                                torch.tensor(np.asarray(cam.intrinsics)),
                                WIDTH, HEIGHT, XLA_CFG)
    assert proj["valid"].tolist() == [False, True]
    assert float(proj["radius"][0]) == 0.0
    rgb, alpha, _ = TR.rasterize_arrays(
        [[0.0, 0.0, -10.0]], [[0.5, 0, 0, 0.5, 0, 0.5]], [0.99], np.ones((1, 1, 3)),
        np.asarray(cam.viewmat), np.asarray(cam.intrinsics), WIDTH, HEIGHT, 0,
        (0.5, 0.5, 0.5), XLA_CFG, device="cpu")
    assert float(alpha.abs().max()) == 0.0
    np.testing.assert_allclose(rgb.numpy(), 0.5, atol=1e-6)
