"""Torch port: sharded rendering, its gradients and the sharded train step
on gloo ranks, against the JAX package on the conftest's virtual devices at
the same mesh shapes (tests/test_parallel.py) and against the port on one
process.

The port's ranks run in spawned processes (`tests/torch_dist_workers.py`),
one group of 2 and one of 4 for the whole module; each case is still its
own test. Tolerances are the JAX suite's: rgb and alpha 1e-5, depth 1e-4,
gradients rtol 1e-3 / atol 1e-5, the train-step loss gap 1e-4.
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from gaussiansplattingregistration_tpu.models.camera import Camera as JCamera
from gaussiansplattingregistration_tpu.ops.rasterize import RasterizeConfig as JConfig
from gaussiansplattingregistration_tpu.ops.rasterize import rasterize as j_rasterize
from gaussiansplattingregistration_tpu.ops.rasterize import rasterize_arrays as j_rasterize_arrays
from gaussiansplattingregistration_tpu.parallel.mesh import make_mesh as j_make_mesh
from gaussiansplattingregistration_tpu.parallel.sharded_raster import (
    rasterize_arrays_sharded as j_rasterize_arrays_sharded,
    rasterize_sharded as j_rasterize_sharded,
)
from gaussiansplattingregistration_tpu.parallel.train_step import (
    make_photometric_train_step as j_make_train_step,
    shard_splats as j_shard_splats,
)
from gaussiansplattingregistration_tpu_torch.ops.rasterize import RasterizeConfig, rasterize
from gaussiansplattingregistration_tpu_torch.parallel.mesh import mesh_shape
from tests.scene_utils import make_random_cloud
from tests.test_parallel import make_camera, make_scene
from tests.torch_dist_workers import (
    camera_case,
    cloud_case,
    port_camera,
    port_cloud,
    run_group,
    single_device_step,
)
from port_scenes import two_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_torch_threads")

CFG = dict(max_splats_per_tile=64, tile_chunk=4)
BG = (0.2, 0.1, 0.3)
# The multi-chip dry run's config (K=32 < n: per-tile truncation binds) and the
# untruncated one both train-step compositors agree on.
CFG_DRYRUN = dict(max_tiles_per_splat=9, max_splats_per_tile=32, tile_chunk=1)
CFG_STEP = dict(max_tiles_per_splat=9, max_splats_per_tile=64, tile_chunk=1)
CFG_OVERFLOW = dict(max_tiles_per_splat=4, max_splats_per_tile=32, tile_chunk=1)
XI0 = np.asarray([0.01, -0.02, 0.005, 0.03, -0.01, 0.02], np.float32)
# bench.py config 5's scene and config cut to 20k splats at 320x200 (13
# tile rows, padded to 14 over 2 ranks), K=64 < the deepest tile.
CFG_BINDING = dict(max_tiles_per_splat=4, max_splats_per_tile=64, tile_chunk=32)


def binding_scene():
    w, h = 320, 200
    f = w / (2 * math.tan(math.radians(70) / 2))
    return (make_random_cloud(np.random.default_rng(4), n=20_000, sh_degree=1,
                              scale_range=(0.005, 0.02)),
            JCamera.create(np.eye(3), [0.0, 0.0, 3.0], f, f, w, h))


def jax_mesh(shape):
    return j_make_mesh(data=shape[0], splat=shape[1],
                       devices=jax.devices()[:shape[0] * shape[1]])


def render_case(shape):
    rng = np.random.default_rng(42)
    return {"kind": "render", "mesh": shape, "cloud": cloud_case(make_scene(rng)),
            "camera": camera_case(make_camera()), "config": CFG, "background": BG,
            "compositor": "all_gather", "capacity_slack": 1.5}


def grad_case(shape):
    rng = np.random.default_rng(42)
    return {"kind": "render_grad", "mesh": shape, "cloud": cloud_case(make_scene(rng, n=64)),
            "camera": camera_case(make_camera(32, 32)), "config": CFG,
            "compositor": "all_gather", "capacity_slack": 1.5}


def step_case(shape, config, compositor, n=64, n_cams=4, xi0=XI0, steps=1, slack=1.5):
    """tests/test_parallel.py's train-step inputs: the scene from rng 42,
    targets from rng 7, identical cameras at 32x32."""
    scene = make_scene(np.random.default_rng(42), n=n)
    targets = np.random.default_rng(7).uniform(0, 1, size=(n_cams, 32, 32, 3))
    return {"kind": "train_step", "mesh": shape, "cloud": cloud_case(scene),
            "cameras": [camera_case(make_camera(32, 32))] * n_cams,
            "targets": targets.astype(np.float32), "config": config,
            "compositor": compositor, "capacity_slack": slack, "xi0": xi0, "steps": steps}


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Every case of this module on gloo ranks: one group of 2, one of 4."""
    groups = {
        2: {"render_1x2": render_case((1, 2)),
            "render_binding": {**render_case((1, 2)), "config": CFG_BINDING,
                               "cloud": cloud_case(binding_scene()[0]),
                               "camera": camera_case(binding_scene()[1])}},
        4: {"mesh_2x2": {"kind": "mesh", "mesh": (2, 2)},
            "render_1x4": render_case((1, 4)), "render_2x2": render_case((2, 2)),
            "grad_1x4": grad_case((1, 4)), "grad_2x2": grad_case((2, 2)),
            "step_dryrun": step_case((2, 2), CFG_DRYRUN, "all_gather", xi0=None, steps=2),
            "step_all_gather": step_case((2, 2), CFG_STEP, "all_gather"),
            "step_depth_sharded": step_case((2, 2), CFG_STEP, "depth_sharded"),
            "step_overflow": step_case((2, 2), CFG_OVERFLOW, "depth_sharded", n=8192,
                                       n_cams=2, xi0=None, slack=0.1)},
    }
    out = {}
    for world, cases in groups.items():
        out.update(run_group(world, cases, str(tmp_path_factory.mktemp(f"ranks{world}"))))
    out["cases"] = {k: v for cases in groups.values() for k, v in cases.items()}
    return out


def jax_train_step(case):
    """JAX's step on the case's inputs at its mesh shape: (loss, xi) per step
    and the dropped count."""
    mesh = jax_mesh(case["mesh"])
    jcfg = JConfig(**case["config"])
    scene = make_scene(np.random.default_rng(42), n=case["cloud"]["xyz"].shape[0])
    step, init, pad_targets = j_make_train_step(
        mesh, 32, 32, scene.sh_degree, jcfg, compositor=case["compositor"],
        capacity_slack=case["capacity_slack"])
    shard = NamedSharding(mesh, P("data"))
    cams = [make_camera(32, 32)] * len(case["cameras"])
    args = (j_shard_splats(scene, mesh),
            jax.device_put(jnp.stack([c.viewmat for c in cams]), shard),
            jax.device_put(jnp.stack([c.intrinsics for c in cams]), shard),
            jax.device_put(pad_targets(jnp.asarray(case["targets"])), shard))
    xi, opt_state = init(None if case["xi0"] is None else jnp.asarray(case["xi0"]))
    out = []
    for _ in range(case["steps"]):
        xi, opt_state, loss, dropped = step(xi, opt_state, *args)
        out.append((float(loss), np.asarray(xi)))
    return out, int(dropped)


def test_gloo_ranks_form_the_mesh(port_runs):
    """The counterpart of the 8-device check: 4 ranks, a (2, 2) mesh whose
    subgroups hold the ranks of rank 0's row and column."""
    m = port_runs["mesh_2x2"]
    assert m["world"] == 4 and m["rank"] == 0
    assert m["data"]["size"] == m["splat"]["size"] == 2
    assert m["data"]["rank"] == m["splat"]["rank"] == 0
    np.testing.assert_array_equal(m["data"]["gathered"], [0.0, 2.0])
    np.testing.assert_array_equal(m["splat"]["gathered"], [0.0, 1.0])


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)])
def test_sharded_rasterize_matches_jax_and_single(port_runs, shape):
    name = f"render_{shape[0]}x{shape[1]}"
    case, got = port_runs["cases"][name], port_runs[name]
    scene, cam = make_scene(np.random.default_rng(42)), make_camera()
    want = j_rasterize_sharded(scene, cam, jax_mesh(shape), background=BG, config=JConfig(**CFG))
    single = rasterize(port_cloud(case["cloud"]), port_camera(case["camera"]), background=BG,
                       config=RasterizeConfig(**CFG), device="cpu")
    for key, w, s, tol in zip(("rgb", "alpha", "depth"), want, single, (1e-5, 1e-5, 1e-4)):
        np.testing.assert_allclose(got[key], np.asarray(w), atol=tol)
        np.testing.assert_allclose(got[key], s.numpy(), atol=tol)
    assert got["alpha"].max() > 0.5


def test_sharded_rasterize_sorts_and_truncates_as_one_process(port_runs):
    """Where K binds and coverage clipping reaches the padded tile row, each
    rank's slab keeps the entries, order and truncation of one process: 2
    ranks equal the port's single render (and JAX's) within 1e-6 / 1e-5. The
    JAX package's sharded render departs from its own single render there
    (it keys each slab by the slab's tile count and bins against the padded
    rows; ROADMAP Queue 3); the port does not carry that over."""
    case, got = port_runs["cases"]["render_binding"], port_runs["render_binding"]
    scene, cam = binding_scene()
    single = rasterize(port_cloud(case["cloud"]), port_camera(case["camera"]), background=BG,
                       config=RasterizeConfig(**CFG_BINDING), device="cpu")
    want = j_rasterize(scene, cam, background=BG, config=JConfig(**CFG_BINDING))
    for key, s, w, tol in zip(("rgb", "alpha", "depth"), single, want, (1e-5, 1e-5, 1e-4)):
        np.testing.assert_allclose(got[key], s.numpy(), atol=1e-6)
        np.testing.assert_allclose(got[key], np.asarray(w), atol=tol)
    j_sharded = j_rasterize_sharded(scene, cam, jax_mesh((1, 2)), background=BG,
                                    config=JConfig(**CFG_BINDING))
    assert np.abs(np.asarray(j_sharded[0]) - np.asarray(want[0])).max() > 1e-2


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_sharded_rasterize_gradients(port_runs, shape):
    """d sum(rgb) / d means through both gathers against JAX's sharded
    gradient and the port's single-process one. At (2, 2) the splat groups
    are {0, 1} and {2, 3}: the autograd gather's backward on a group that
    lacks rank 0."""
    import torch

    from gaussiansplattingregistration_tpu_torch.ops.rasterize import rasterize_arrays

    name = f"grad_{shape[0]}x{shape[1]}"
    case, got = port_runs["cases"][name], port_runs[name]["grad"]
    scene, cam = make_scene(np.random.default_rng(42), n=64), make_camera(32, 32)
    mesh = jax_mesh(shape)
    shard = NamedSharding(mesh, P("splat"))
    cov, op, feats = (jax.device_put(a, shard) for a in
                      (scene.get_covariance(), scene.get_opacity[:, 0], scene.get_features))

    def loss(means):
        rgb, _, _ = j_rasterize_arrays_sharded(
            means, cov, op, feats, cam.viewmat, cam.intrinsics, 32, 32, scene.sh_degree,
            jnp.zeros(3), JConfig(**CFG), mesh=mesh)
        return jnp.sum(rgb)

    want = np.asarray(jax.grad(loss)(jax.device_put(scene.xyz, shard)))
    c, pc = port_cloud(case["cloud"]), port_camera(case["camera"])
    means = c.xyz.clone().requires_grad_(True)
    rgb = rasterize_arrays(means, c.covariance, c.get_opacity[:, 0], c.get_features,
                           pc.viewmat, pc.intrinsics, 32, 32, c.sh_degree, torch.zeros(3),
                           RasterizeConfig(**CFG), device="cpu")[0]
    rgb.sum().backward()
    assert np.all(np.isfinite(got)) and np.abs(got).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(got, means.grad.numpy(), rtol=1e-3, atol=1e-5)


def test_mesh_validation():
    """`mesh_shape` raises where the JAX package's `make_mesh` does; it needs
    no process group."""
    with pytest.raises(ValueError):
        j_make_mesh(data=3, devices=jax.devices())
    with pytest.raises(ValueError):
        mesh_shape(8, data=3)
    with pytest.raises(ValueError):
        mesh_shape(4, data=2, splat=3)
    assert mesh_shape(8, data=2) == (2, 4) and mesh_shape(4, 2, 2) == (2, 2)


def test_photometric_train_step_at_dryrun_config(port_runs):
    """Two sharded steps at the multi-chip dry run's config (odd C=9, K=32) on a
    (2, 2) mesh: losses and poses against JAX's at the same mesh, the first
    gradient against the port's single-process one, and the second step
    moves the pose."""
    case, got = port_runs["cases"]["step_dryrun"], port_runs["step_dryrun"]
    want, _ = jax_train_step(case)
    loss1, grad1 = single_device_step(case["cloud"], case["cameras"], case["targets"],
                                      np.zeros(6), case["config"])
    assert np.all(np.isfinite(got["loss"])) and np.all(np.isfinite(got["xi"]))
    for (w_loss, w_xi), loss, xi in zip(want, got["loss"], got["xi"]):
        assert abs(loss - w_loss) < 1e-4, (loss, w_loss)
        np.testing.assert_allclose(xi, w_xi, rtol=1e-3, atol=1e-5)
    assert abs(got["loss"][0] - loss1) < 1e-5 * max(loss1, 1.0)
    np.testing.assert_allclose(got["grad"][0], grad1, rtol=1e-3, atol=1e-5)
    assert not np.allclose(got["xi"][1], got["xi"][0])
    assert got["dropped"] == [0, 0]


def test_train_step_depth_sharded_matches_all_gather(port_runs):
    """Both compositors under the data axis, untruncated (K >= n): the same
    loss and the single-process gradient of xi, not only xi after Adam
    (whose first step is ~lr * sign(g) and would hide a gradient scaled by
    a mesh size)."""
    cases = {c: port_runs["cases"][f"step_{c}"] for c in ("all_gather", "depth_sharded")}
    loss1, grad1 = single_device_step(cases["all_gather"]["cloud"],
                                      cases["all_gather"]["cameras"],
                                      cases["all_gather"]["targets"], XI0, CFG_STEP)
    results = {}
    for comp, case in cases.items():
        got = port_runs[f"step_{comp}"]
        (w_loss, w_xi), = jax_train_step(case)[0]
        assert got["dropped"] == [0]
        assert abs(got["loss"][0] - w_loss) < 1e-4, (comp, got["loss"][0], w_loss)
        np.testing.assert_allclose(got["xi"][0], w_xi, rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(got["grad"][0], grad1, rtol=1e-3, atol=1e-5)
        results[comp] = got
    assert abs(results["all_gather"]["loss"][0] - loss1) < 1e-5
    assert abs(results["all_gather"]["loss"][0] - results["depth_sharded"]["loss"][0]) < 1e-4
    np.testing.assert_allclose(results["depth_sharded"]["xi"][0], results["all_gather"]["xi"][0],
                               rtol=1e-3, atol=1e-5)


def test_train_step_depth_sharded_overflow_counter(port_runs):
    """8192 splats over 2 splat ranks at slack 0.1: each bucket holds 256
    records, far fewer than a depth slice; the step reports the truncation
    as JAX's does."""
    case, got = port_runs["cases"]["step_overflow"], port_runs["step_overflow"]
    _, j_dropped = jax_train_step(case)
    assert np.isfinite(got["loss"][0])
    assert got["dropped"][0] > 0 and j_dropped > 0
