"""Torch port vs JAX package: rendered images and stats of the forward
rasterizer, against JAX renders and the committed f64 golden.

Inputs and tolerances as in test_torch_rasterize.py: rgb and alpha atol
1e-5, depth atol 1e-4, the integer stats exactly; the golden at 1e-3 (its
own contract, tests/test_goldens.py).
"""

import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gaussiansplattingregistration_tpu.ops import rasterize as JR
from gaussiansplattingregistration_tpu_torch.models.camera import Camera
from gaussiansplattingregistration_tpu_torch.models.gaussian_cloud import GaussianCloud
from gaussiansplattingregistration_tpu_torch.ops import rasterize as TR
from tests.test_rasterize import make_camera, make_scene
from tests.test_torch_rasterize import (
    DATA, XLA_CFG, assert_images_close, assert_stats_equal, jax_config, render_both,
    scene_arrays,
)
from port_scenes import two_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_torch_threads")


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_rasterize_arrays_matches_jax(rng, backend):
    cloud, cam = make_scene(rng, n=50), make_camera()
    cfg = dataclasses.replace(XLA_CFG, backend=backend)
    got, want = render_both(scene_arrays(cloud, cam), (0.1, 0.2, 0.3), cfg)
    assert_images_close(got, want)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_rasterize_cloud_camera_matches_jax(rng, backend):
    """The slice as a whole: a JAX cloud carried across by from_numpy_dict,
    a JAX camera by from_numpy, rendered by both packages."""
    jcloud, jcam = make_scene(rng, n=50, sh_degree=2), make_camera()
    cloud = GaussianCloud.from_numpy_dict(jcloud.to_numpy_dict(), device="cpu")
    cam = Camera.from_numpy(np.asarray(jcam.rotation), np.asarray(jcam.position),
                            float(jcam.fx), float(jcam.fy), jcam.width, jcam.height,
                            device="cpu")
    cfg = dataclasses.replace(XLA_CFG, backend=backend)
    got = TR.rasterize(cloud, cam, background=(0.1, 0.2, 0.3), scaling_modifier=0.9,
                       config=cfg, device="cpu")
    want = JR.rasterize(jcloud, jcam, background=(0.1, 0.2, 0.3), scaling_modifier=0.9,
                        config=jax_config(cfg))
    assert_images_close(got, want)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_render_matches_golden(backend):
    g = np.load(os.path.join(DATA, "golden_raster.npz"))
    cfg = TR.RasterizeConfig(max_tiles_per_splat=16, max_splats_per_tile=64, tile_chunk=4,
                             backend=backend)
    rgb, acc, _ = TR.rasterize_arrays(
        g["means"], g["cov6"], g["opacity"], g["features"], g["viewmat"], g["intrinsics"],
        int(g["width"]), int(g["height"]), int(g["sh_degree"]), g["background"], cfg,
        device="cpu")
    np.testing.assert_allclose(rgb.numpy(), g["rgb"], atol=1e-3)
    np.testing.assert_allclose(acc.numpy(), g["acc"], atol=1e-3)


# -------------------------------------------------------- (e) stats dict

@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("scene", ["pathological", "benign", "deep"])
def test_stats_match_jax(rng, backend, scene):
    if scene == "deep":
        # Two 128-entry chunks and saturating tiles: a non-trivial horizon.
        cloud = make_scene(rng, n=400, sh_degree=0, spread=0.3, scale=(0.1, 0.3))
        cfg = TR.RasterizeConfig(max_tiles_per_splat=8, max_splats_per_tile=192,
                                 max_bwd_splats_per_tile=128, backend=backend)
    else:
        cloud = make_scene(rng, n=64, sh_degree=0, spread=0.3, scale=(0.5, 0.8))
        cfg = (TR.RasterizeConfig(max_tiles_per_splat=1, max_splats_per_tile=8, backend=backend)
               if scene == "pathological" else
               TR.RasterizeConfig(max_tiles_per_splat=64, max_splats_per_tile=256,
                                  backend=backend))
    got, want = render_both(scene_arrays(cloud, make_camera()), (0.0, 0.0, 0.0), cfg,
                            with_stats=True)
    assert_images_close(got, want)
    assert_stats_equal(got[3], want[3])
    stats = got[3]
    if scene == "pathological":
        assert int(stats["coverage_clipped_splats"]) > 0 and int(stats["overflow_tiles"]) > 0
    if scene == "benign":
        assert int(stats["dropped_entries"]) == 0 and int(stats["bwd_cap_violations"]) == 0
    if scene == "deep" and backend == "cuda":
        assert int(stats["max_live"]) == 192 and int(stats["bwd_cap_violations"]) > 0


@pytest.mark.parametrize("cap", ["fits", "slices"])
def test_max_live_tiles_matches_jax(rng, cap):
    """The occupancy-row cap (a "cuda"/"pallas"-only feature) on a 10x6-tile
    view whose live tiles have the highest image ids: exact when every
    non-empty tile fits under a cap that slices rows off, counted in
    live_tile_overflow when it does not."""
    W, H = 160, 96
    cloud = make_scene(rng, n=300, spread=0.5, scale=(0.02, 0.06))
    cloud = dataclasses.replace(cloud, xyz=cloud.xyz + jnp.asarray([0.8, 0.6, 0.0], jnp.float32))
    arrays = scene_arrays(cloud, make_camera(width=W, height=H))
    base = TR.RasterizeConfig(max_tiles_per_splat=4, max_splats_per_tile=64, tile_chunk=4)
    full, _ = render_both(arrays, (0.3, 0.1, 0.2), base, with_stats=True)
    counts = TR._build_tile_table(*_projected(arrays, base), W // 16, H // 16, base)[3]
    n_nonempty = int((counts > 0).sum())
    assert 8 < n_nonempty and -(-n_nonempty // 8) * 8 < 60   # both caps slice rows
    cfg = dataclasses.replace(base, max_live_tiles=n_nonempty if cap == "fits" else 8)
    got, want = render_both(arrays, (0.3, 0.1, 0.2), cfg, with_stats=True)
    assert_images_close(got, want)
    assert_stats_equal(got[3], want[3])
    overflow = int(got[3]["live_tile_overflow"])
    if cap == "fits":
        assert overflow == 0
        np.testing.assert_allclose(got[0].numpy(), full[0].numpy(), atol=1e-6)
    else:
        assert overflow == n_nonempty - 8


def _projected(arrays, cfg):
    means, cov, _, _, viewmat, intr, w, h, _ = arrays
    proj = TR.project_gaussians(*(torch.tensor(a) for a in (means, cov, viewmat, intr)),
                                w, h, cfg)
    return proj["means2d"], proj["radius"], proj["depth"], proj["valid"]


