"""Torch port: the depth-sharded compositor on gloo ranks, against the JAX
package on the conftest's virtual devices at the same mesh shapes
(tests/test_compositor.py) and against the port on one process.

With transmittance_min = 0 and no per-tile truncation the fold is exact:
rgb and alpha within 1e-5, depth 1e-4, gradients rtol 1e-3 / atol 1e-5.
With early termination on, the deviation from one process is bounded by
10 * transmittance_min. One group of 2 ranks and one of 4 run every case.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from gaussiansplattingregistration_tpu.ops import math3d as jmath3d
from gaussiansplattingregistration_tpu.ops.rasterize import RasterizeConfig as JConfig
from gaussiansplattingregistration_tpu.parallel.compositor import (
    rasterize_arrays_depth_sharded as j_rasterize_arrays_depth_sharded,
    rasterize_depth_sharded as j_rasterize_depth_sharded,
)
from gaussiansplattingregistration_tpu.parallel.mesh import make_mesh as j_make_mesh
from gaussiansplattingregistration_tpu_torch.ops.rasterize import (
    RasterizeConfig,
    rasterize,
    rasterize_arrays_with_stats,
)
from tests.test_compositor import make_camera, make_scene
from tests.torch_dist_workers import camera_case, cloud_case, port_camera, port_cloud, run_group
from port_scenes import two_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_torch_threads")

CFG_EXACT = dict(max_splats_per_tile=256, tile_chunk=4, transmittance_min=0.0)
CFG_DEFAULT = dict(max_splats_per_tile=256, tile_chunk=4)
CFG_K = dict(CFG_EXACT, max_splats_per_tile=64)
CFG_ORACLE = dict(CFG_EXACT, max_splats_per_tile=1024)
BG = (0.2, 0.1, 0.3)


def squeezed_scene(rng, n):
    """test_capacity_overflow_is_counted's scene: depths squeezed together,
    so one bucket takes nearly everything."""
    cloud = make_scene(rng, n=n)
    tight = dataclasses.replace(cloud, xyz=cloud.xyz * jnp.asarray([1.0, 1.0, 0.001]))
    return dataclasses.replace(tight, covariance=jmath3d.covariance_from_scaling_rotation(
        tight.get_scaling, tight.get_rotation))


# name -> (scene function, camera size, config, slack, background, mesh shape)
SCENES = {
    "exact_2": (lambda: make_scene(np.random.default_rng(42)), (64, 48), CFG_EXACT, 8.0, BG, 2),
    "exact_4": (lambda: make_scene(np.random.default_rng(42)), (64, 48), CFG_EXACT, 8.0, BG, 4),
    "early_termination": (lambda: make_scene(np.random.default_rng(42), n=300), (64, 48),
                          CFG_DEFAULT, 8.0, (0.0, 0.0, 0.0), 4),
    "k_binding": (lambda: make_scene(np.random.default_rng(42), n=900), (48, 32), CFG_K, 8.0,
                  (0.0, 0.0, 0.0), 4),
    "overflow": (lambda: squeezed_scene(np.random.default_rng(42), 400), (64, 48), CFG_EXACT,
                 0.3, (0.0, 0.0, 0.0), 2),
}


def case_of(name, kind="render"):
    build, (w, h), config, slack, bg, n_dev = SCENES[name]
    return {"kind": kind, "mesh": (1, n_dev), "cloud": cloud_case(build()),
            "camera": camera_case(make_camera(w, h)), "config": config, "background": bg,
            "compositor": "depth_sharded", "capacity_slack": slack}


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    grad = {"kind": "render_grad", "mesh": (1, 4),
            "cloud": cloud_case(make_scene(np.random.default_rng(42), n=64)),
            "camera": camera_case(make_camera(32, 32)), "config": CFG_EXACT,
            "compositor": "depth_sharded", "capacity_slack": 8.0}
    groups = {2: {k: case_of(k) for k in ("exact_2", "overflow")},
              4: {**{k: case_of(k) for k in ("exact_4", "early_termination", "k_binding")},
                  "grad": grad}}
    out = {}
    for world, cases in groups.items():
        out.update(run_group(world, cases, str(tmp_path_factory.mktemp(f"ranks{world}"))))
    return out


def jax_render(name):
    """JAX's depth-sharded render of the named scene at its mesh shape."""
    build, (w, h), config, slack, bg, n_dev = SCENES[name]
    mesh = j_make_mesh(data=1, splat=n_dev, devices=jax.devices()[:n_dev])
    return j_rasterize_depth_sharded(build(), make_camera(w, h), mesh, background=bg,
                                     config=JConfig(**config), capacity_slack=slack)


def port_single(name, config=None):
    build, (w, h), cfg, _, bg, _ = SCENES[name]
    case = case_of(name)
    return rasterize(port_cloud(case["cloud"]), port_camera(case["camera"]), background=bg,
                     config=RasterizeConfig(**(config or cfg)), device="cpu")


@pytest.mark.parametrize("n_dev", [2, 4])
def test_depth_sharded_matches_jax_and_single_exact(port_runs, n_dev):
    name = f"exact_{n_dev}"
    got = port_runs[name]
    want = jax_render(name)
    single = port_single(name)
    assert int(got["dropped"]) == 0 and int(want[3]) == 0
    for key, w, s, tol in zip(("rgb", "alpha", "depth"), want, single, (1e-5, 1e-5, 1e-4)):
        np.testing.assert_allclose(got[key], np.asarray(w), atol=tol)
        np.testing.assert_allclose(got[key], s.numpy(), atol=tol)


def test_depth_sharded_early_termination_bounded(port_runs):
    """With early termination on, within 10 * transmittance_min of one
    process, and within 1e-5 of JAX's depth-sharded render (the same
    per-bucket termination)."""
    got = port_runs["early_termination"]
    assert int(got["dropped"]) == 0
    err = np.abs(got["rgb"] - port_single("early_termination")[0].numpy()).max()
    assert err <= 10.0 * JConfig(**CFG_DEFAULT).transmittance_min, err
    np.testing.assert_allclose(got["rgb"], np.asarray(jax_render("early_termination")[0]),
                               atol=1e-5)


def test_depth_sharded_gradients_match_jax_and_single(port_runs):
    import torch

    from gaussiansplattingregistration_tpu_torch.ops.rasterize import rasterize_arrays

    got = port_runs["grad"]["grad"]
    scene, cam = make_scene(np.random.default_rng(42), n=64), make_camera(32, 32)
    mesh = j_make_mesh(data=1, splat=4, devices=jax.devices()[:4])
    shard = NamedSharding(mesh, P("splat"))
    cov, op, feats = (jax.device_put(a, shard) for a in
                      (scene.get_covariance(), scene.get_opacity[:, 0], scene.get_features))

    def loss(means):
        rgb, _, _, _ = j_rasterize_arrays_depth_sharded(
            means, cov, op, feats, cam.viewmat, cam.intrinsics, 32, 32, scene.sh_degree,
            jnp.zeros(3), JConfig(**CFG_EXACT), mesh=mesh, capacity_slack=8.0)
        return jnp.sum(rgb)

    want = np.asarray(jax.grad(loss)(jax.device_put(scene.xyz, shard)))
    c = port_cloud(cloud_case(scene))
    pc = port_camera(camera_case(cam))
    means = c.xyz.clone().requires_grad_(True)
    rgb = rasterize_arrays(means, c.covariance, c.get_opacity[:, 0], c.get_features,
                           pc.viewmat, pc.intrinsics, 32, 32, c.sh_degree, torch.zeros(3),
                           RasterizeConfig(**CFG_EXACT), device="cpu")[0]
    rgb.sum().backward()
    assert np.all(np.isfinite(got)) and np.abs(got).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(got, means.grad.numpy(), rtol=1e-3, atol=1e-5)


def test_depth_sharded_in_k_binding_regime(port_runs):
    """Per-tile K truncation binds in one process; per-bucket truncation
    keeps the front-most K of each depth slice, a superset, so the sharded
    render is at least as close to the untruncated oracle; and it is JAX's
    sharded render within 1e-5."""
    case = case_of("k_binding")
    c, cam = port_cloud(case["cloud"]), port_camera(case["camera"])
    *_, stats = rasterize_arrays_with_stats(
        c.xyz, c.covariance, c.get_opacity[:, 0], c.get_features, cam.viewmat, cam.intrinsics,
        48, 32, c.sh_degree, (0.0, 0.0, 0.0), RasterizeConfig(**CFG_K), device="cpu")
    assert int(stats["overflow_tiles"]) > 0 and int(stats["max_run"]) > 64, stats
    exact = port_single("k_binding", CFG_ORACLE)[0].numpy()
    err_1 = np.abs(port_single("k_binding")[0].numpy() - exact).max()
    got = port_runs["k_binding"]
    assert int(got["dropped"]) == 0
    err_n = np.abs(got["rgb"] - exact).max()
    assert err_1 > 1e-3, err_1
    assert err_n <= err_1 + 1e-5, (err_n, err_1)
    np.testing.assert_allclose(got["rgb"], np.asarray(jax_render("k_binding")[0]), atol=1e-5)


def test_capacity_overflow_is_counted(port_runs):
    """A bucket capacity too small for the scene is reported, by the port's
    ranks as by JAX's devices."""
    assert int(port_runs["overflow"]["dropped"]) > 0
    assert int(jax_render("overflow")[3]) > 0
