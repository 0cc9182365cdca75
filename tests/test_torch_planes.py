"""Torch port vs JAX package: plane fitting, plane-inlier flows, workspace.

The same seeded numpy inputs go through both packages on the CPU.
Tolerances: with JAX's sample draws injected (the test replays its
split/choice sequence), `_fit_single_plane` and `fit_planes` give the same
planes within 1e-5 and the same inlier sets; `project_points_onto_plane`
within 1e-6 and `plane_grid_points` equal; `select_plane_inliers` equal;
`merge_plane_inliers(backend="native")` (numpy draws in both packages) at
tests/test_torch_hem.py's native tolerance, 1e-6. The workspace cases of
tests/test_workspace.py and tests/test_planes.py, and the CLI plane flow of
tests/test_planes.py on `--device cpu`, run on the port's types.
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiansplattingregistration_tpu.models.parameters import (
    GaussianMixtureParams as JGaussianMixtureParams,
    PlaneFittingParams as JPlaneFittingParams,
)
from gaussiansplattingregistration_tpu.ops import plane_fitting as jpf
from gaussiansplattingregistration_tpu.ops import se3 as jse3
from gaussiansplattingregistration_tpu.pipelines import planes as jplanes
from gaussiansplattingregistration_tpu_torch.cli.main import main as port_main
from gaussiansplattingregistration_tpu_torch.models.gaussian_cloud import GaussianCloud
from gaussiansplattingregistration_tpu_torch.models.parameters import (
    GaussianMixtureParams,
    PlaneFittingParams,
)
from gaussiansplattingregistration_tpu_torch.models.point_cloud import PointCloud
from gaussiansplattingregistration_tpu_torch.models.workspace import Workspace
from gaussiansplattingregistration_tpu_torch.ops import hem, plane_fitting as pf
from gaussiansplattingregistration_tpu_torch.pipelines import planes
from gaussiansplattingregistration_tpu_torch.utils import io as tio
from tests.conftest import make_random_cloud
from tests.test_hem import make_dense_cloud
from tests.test_planes import make_planar_cloud
from port_scenes import two_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_torch_threads")

PARAMS = dict(plane_count=2, iterations=300, distance_threshold=0.02, normal_threshold=0.8,
              min_distance=0.2)


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def port_cloud(jcloud):
    return GaussianCloud.from_numpy_dict(jcloud.to_numpy_dict(), device="cpu")


@pytest.fixture(scope="module")
def planar():
    """tests/test_planes.py's planar scene with normals estimated by JAX:
    (JAX point cloud, port point cloud, plane a, plane b, noise indices)."""
    jcloud, idx_a, idx_b, idx_noise = make_planar_cloud(np.random.default_rng(42))
    from gaussiansplattingregistration_tpu.utils import io as jio

    jpc = jio.gaussian_to_point_cloud(jcloud, estimate_missing_normals=True)
    pc = PointCloud(points=t(jpc.points), normals=t(jpc.normals))
    return jpc, pc, idx_a, idx_b, idx_noise


def jax_plane_draws(seed, n, masks, iterations):
    """The [iterations, 3] samples JAX's fit_planes draws for each plane,
    given the active mask before each plane."""
    key = jax.random.PRNGKey(seed)
    out = []
    for active in masks:
        key, sub = jax.random.split(key)
        probs = jnp.asarray(active, jnp.float32)
        probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
        out.append(np.asarray(jax.random.choice(sub, n, shape=(iterations, 3), replace=True,
                                                p=probs)))
    return out


def test_fit_single_plane_matches_jax(planar):
    jpc, pc, *_ = planar
    n = pc.num_points
    active = np.ones(n, bool)
    active[::7] = False
    key = jax.random.PRNGKey(11)
    jplane, jin, jcount = jpf._fit_single_plane(
        key, jpc.points, jpc.normals, jnp.asarray(active), jnp.asarray(0.02, jnp.float32),
        jnp.asarray(0.8, jnp.float32), jnp.asarray(0.2, jnp.float32), 300)
    probs = jnp.asarray(active, jnp.float32) / active.sum()
    samples = np.asarray(jax.random.choice(key, n, shape=(300, 3), replace=True, p=probs))
    plane, inliers, count = pf._fit_single_plane(
        None, pc.points, pc.normals, torch.tensor(active), 0.02, 0.8, 0.2, 300, samples=samples)
    np.testing.assert_allclose(plane.numpy(), np.asarray(jplane), atol=1e-5)
    np.testing.assert_array_equal(inliers.numpy(), np.asarray(jin))
    assert int(count) == int(jcount) > 350


@pytest.mark.parametrize("seed", [0, 3])
def test_fit_planes_with_jax_draws_matches_jax(planar, seed):
    jpc, pc, idx_a, idx_b, _ = planar
    jcoef, jlists = jpf.fit_planes(jpc, JPlaneFittingParams(**PARAMS), seed=seed)
    masks, active = [], np.ones(pc.num_points, bool)
    for ix in jlists:
        masks.append(active.copy())
        active[ix] = False
    draws = jax_plane_draws(seed, pc.num_points, masks, PARAMS["iterations"])
    coef, lists = pf.fit_planes(pc, PlaneFittingParams(**PARAMS), samples=draws)
    assert len(coef) == len(jcoef) == 2
    for a, b in zip(coef, jcoef):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)
    for a, b in zip(lists, jlists):
        np.testing.assert_array_equal(a, b)
    # The two planes of the scene, in either order.
    found = sorted(len(np.intersect1d(ix, ref)) for ix in lists for ref in (idx_a, idx_b))
    assert found[-2:][0] > 400 and found[-1] > 400


def test_fit_planes_own_draws_find_both_planes(planar):
    _, pc, idx_a, idx_b, _ = planar
    coef, lists = pf.fit_planes(PointCloud(points=pc.points), PlaneFittingParams(**PARAMS),
                                seed=0)   # normals estimated by the port
    assert len(coef) == 2 and all(len(ix) > 350 for ix in lists)
    normals = sorted(np.argmax(np.abs(c[:3])) for c in coef)
    assert normals == [1, 2]            # y ~ 1 and z ~ 0
    assert all(abs(np.linalg.norm(c[:3]) - 1) < 1e-5 for c in coef)


def test_plane_sample_draw_beyond_multinomial_limit():
    """A cloud of more than 2^24 points (`torch.multinomial`'s category
    limit): the draw runs and lands only on active points, each of them,
    one past 2^24 included."""
    n = 2 ** 24 + 1000
    active = torch.zeros(n, dtype=torch.bool)
    chosen = [5, 2 ** 24 + 7, n - 1]
    active[chosen] = True
    gen = torch.Generator()
    gen.manual_seed(0)
    samples = pf._draw_samples(gen, active, 3000)
    assert samples.shape == (3000,) and samples.dtype == torch.int64
    assert sorted(torch.unique(samples).tolist()) == chosen


def test_projection_and_grid_match_jax(rng):
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    plane = np.array([0.3, -0.5, 0.8, 0.2], np.float32)
    jproj, jd = jpf.project_points_onto_plane(jnp.asarray(pts), jnp.asarray(plane))
    proj, d = pf.project_points_onto_plane(t(pts), t(plane))
    np.testing.assert_allclose(proj.numpy(), np.asarray(jproj), atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-6)
    for p in (plane, np.array([0.0, 0.0, 1.0, -0.5], np.float32)):
        verts, tris = pf.plane_grid_points(p, pts, resolution=6)
        jverts, jtris = jpf.plane_grid_points(p, pts, resolution=6)
        np.testing.assert_array_equal(verts, jverts)
        np.testing.assert_array_equal(tris, jtris)
        assert verts.shape == (36, 3) and tris.shape == (2 * 2 * 25, 3)


def test_select_plane_inliers_matches_jax(planar, tmp_path):
    jpc, pc, idx_a, idx_b, _ = planar
    lists = [idx_b[:40], idx_a[::3]]
    got = planes.select_plane_inliers(pc, lists)
    want = jplanes.select_plane_inliers(jpc, lists)
    np.testing.assert_array_equal(got.points.numpy(), np.asarray(want.points))
    np.testing.assert_array_equal(got.normals.numpy(), np.asarray(want.normals))
    with pytest.raises(ValueError):
        planes.select_plane_inliers(pc, [])
    path = tmp_path / "p.json"
    path.write_text(json.dumps({"planes": [], "inlier_indices": [ix.tolist() for ix in lists]}))
    for a, b in zip(planes.load_plane_indices(str(path)), lists):
        np.testing.assert_array_equal(a, b)
    path.write_text(json.dumps({"planes": []}))
    with pytest.raises(ValueError, match="inlier_indices"):
        planes.load_plane_indices(str(path))


def test_merge_plane_inliers_native_matches_jax(monkeypatch, tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the native library cannot be built")
    from gaussiansplattingregistration_tpu.utils import native as jnative
    from gaussiansplattingregistration_tpu_torch.utils import native

    if jnative.load_library() is None:
        pytest.skip(f"the JAX package's native library is unavailable: {jnative.build_error()}")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    jcloud, idx_a, idx_b, idx_noise = make_planar_cloud(np.random.default_rng(1), n_plane=200,
                                                         n_noise=40)
    got = planes.merge_plane_inliers(port_cloud(jcloud), [idx_a, idx_b],
                                     GaussianMixtureParams(cluster_level=2), seed=4,
                                     backend="native")
    want = jplanes.merge_plane_inliers(jcloud, [idx_a, idx_b],
                                       JGaussianMixtureParams(cluster_level=2), seed=4,
                                       backend="native")
    assert [c.num_points for c in got] == [c.num_points for c in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.xyz.numpy()[:len(idx_noise)],
                                      np.asarray(jcloud.xyz)[idx_noise])
        np.testing.assert_allclose(a.xyz.numpy(), np.asarray(b.xyz), atol=1e-6)
        np.testing.assert_allclose(a.covariance.numpy(), np.asarray(b.covariance), atol=1e-6)


def test_merge_plane_inliers_semantics():
    """tests/test_planes.py's semantics on the torch backend: off-plane
    points pass through every level unchanged as the leading rows; the
    plane parts shrink per level."""
    jcloud, idx_a, idx_b, idx_noise = make_planar_cloud(np.random.default_rng(42))
    cloud = port_cloud(jcloud)
    levels = planes.merge_plane_inliers(cloud, [idx_a, idx_b],
                                        GaussianMixtureParams(cluster_level=2), seed=0)
    assert len(levels) == 2
    unsel = cloud.select(torch.as_tensor(idx_noise))
    for d, lvl in enumerate(levels):
        n_unsel = len(idx_noise)
        np.testing.assert_array_equal(lvl.xyz.numpy()[:n_unsel], unsel.xyz.numpy())
        np.testing.assert_array_equal(lvl.opacity.numpy()[:n_unsel], unsel.opacity.numpy())
        assert 0 < lvl.num_points - n_unsel < (len(idx_a) + len(idx_b)) / (1.6 ** (d + 1))
    assert levels[1].num_points < levels[0].num_points
    with pytest.raises(ValueError):
        planes.merge_plane_inliers(cloud, [], GaussianMixtureParams(cluster_level=1))


# ------------------------------------------------------------- workspace

def test_workspace_transform_notification():
    ws = Workspace()
    seen = []
    ws.on_transformation_changed(lambda T: seen.append(T.copy()))
    ws.transformation = np.eye(4)          # identity -> identity: no change
    assert seen == []
    T2 = np.eye(4)
    T2[0, 3] = 1.0
    ws.transformation = T2
    ws.transformation = T2                 # same value: no re-notify
    assert len(seen) == 1 and ws.transformation.dtype == np.float64


def test_workspace_load_pair_and_levels(rng):
    first = port_cloud(make_dense_cloud(rng, n=150))
    second = port_cloud(make_dense_cloud(rng, n=150))
    ws = Workspace()
    ws.load_pair(first, second)
    assert len(ws.gaussian_list_first) == 1 and ws.point_list_first[0].num_points == 150
    params = GaussianMixtureParams(cluster_level=2)
    lf = hem.create_mixture(first, params, seed=0)
    ls = hem.create_mixture(second, params, seed=1)
    ws.append_mixture_levels(lf, ls, first.sh_degree)
    assert len(ws.gaussian_list_first) == 3 and len(ws.point_list_second) == 3
    assert ws.gaussian_list_first[1].device.type == "cpu"
    ws.current_index = 2
    a, _ = ws.current_pair
    assert a.num_points == lf[1].xyz.shape[0]
    with pytest.raises(ValueError):
        Workspace().load_pair(port_cloud(make_random_cloud(rng, n=10, sh_degree=1)),
                              port_cloud(make_random_cloud(rng, n=10, sh_degree=2)))


def test_workspace_inlier_pair():
    jcloud, idx_a, idx_b, _ = make_planar_cloud(np.random.default_rng(42), n_plane=60,
                                                n_noise=20)
    cloud = port_cloud(jcloud)
    ws = Workspace()
    ws.load_pair(cloud, cloud)
    with pytest.raises(ValueError):
        ws.inlier_pair
    ws.plane_indices_first = [idx_a, idx_b]
    ws.plane_indices_second = [idx_a]
    first, second = ws.inlier_pair
    assert first.num_points == len(idx_a) + len(idx_b) and second.num_points == len(idx_a)
    np.testing.assert_array_equal(
        first.points.numpy(), ws.point_list_first[0].points.numpy()[np.concatenate([idx_a,
                                                                                   idx_b])])


def test_workspace_apply_plane_merge():
    jcloud, idx_a, idx_b, idx_noise = make_planar_cloud(np.random.default_rng(42), n_plane=150,
                                                         n_noise=40)
    cloud = port_cloud(jcloud)
    ws = Workspace()
    ws.load_pair(cloud, cloud)
    ws.gaussian_list_first.append(cloud)           # trimmed away by the merge
    ws.point_list_first.append(ws.point_list_first[0])
    ws.plane_indices_first = [idx_a, idx_b]
    ws.plane_indices_second = [idx_a, idx_b]
    params = GaussianMixtureParams(cluster_level=2, hem_reduction=3.0)
    ws.apply_plane_merge(params, seed=0)
    assert len(ws.gaussian_list_first) == len(ws.gaussian_list_second) == 3
    assert len(ws.point_list_first) == 3
    assert ws.plane_indices_first == [] and ws.plane_indices_second == []
    for lvl in ws.gaussian_list_first[1:]:
        assert len(idx_noise) < lvl.num_points < cloud.num_points
    # The two clouds draw with seeds 0 and 1.
    want = planes.merge_plane_inliers(cloud, [idx_a, idx_b], params, seed=1)
    assert [c.num_points for c in ws.gaussian_list_second[1:]] == [c.num_points for c in want]
    with pytest.raises(ValueError):
        ws.apply_plane_merge(params)               # planes were cleared


# ------------------------------------------------------------------- CLI

def test_cli_plane_flow(tmp_path, capsys):
    """tests/test_planes.py's fit-planes -> register --plane-inliers ->
    merge-planes flow through the port's CLI on the CPU."""
    jcloud, idx_a, idx_b, idx_noise = make_planar_cloud(np.random.default_rng(42))
    cloud = port_cloud(jcloud)
    tgt_path, src_path = tmp_path / "tgt.ply", tmp_path / "src.ply"
    tio.save_gaussian_cloud(cloud, str(tgt_path))
    xi = np.array([0.02, -0.015, 0.01, 0.03, -0.02, 0.015], np.float32)
    T_gt = np.asarray(jse3.se3_exp(jnp.asarray(xi)), np.float64)
    tio.save_gaussian_cloud(cloud.transform(np.linalg.inv(T_gt)), str(src_path))

    def cli(*args):
        port_main([*map(str, args), "--device", "cpu"])
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    planes_t, planes_s = tmp_path / "planes_tgt.json", tmp_path / "planes_src.json"
    for path, out_json in ((tgt_path, planes_t), (src_path, planes_s)):
        out = cli("fit-planes", path, "--plane-count", 2, "--iterations", 300,
                  "--distance-threshold", 0.02, "--normal-threshold", 0.8,
                  "--min-distance", 0.2, "--output", out_json)
        assert set(out) == {"planes", "inlier_counts"} and len(out["planes"]) == 2
        assert all(c > 350 for c in out["inlier_counts"]), out
        saved = json.loads(out_json.read_text())
        assert [len(ix) for ix in saved["inlier_indices"]] == out["inlier_counts"]

    t_out = tmp_path / "t.json"
    cli("register", src_path, tgt_path, "--method", "point_to_plane", "--max-correspondence",
        "0.3", "--max-iteration", "40", "--plane-inliers-first", planes_s,
        "--plane-inliers-second", planes_t, "--output", t_out)
    T_est = np.asarray(json.loads(t_out.read_text())["transformation"])
    err = float(np.linalg.norm(np.asarray(jse3.se3_log(jnp.asarray(T_est @ np.linalg.inv(T_gt),
                                                                   jnp.float32)))))
    assert err < 2e-2, err

    with pytest.raises(SystemExit, match="together"):
        port_main(["register", str(src_path), str(tgt_path), "--plane-inliers-first",
                   str(planes_s), "--device", "cpu"])

    out = cli("merge-planes", tgt_path, planes_t, tmp_path / "merged", "--cluster-level", 2)
    assert set(out) == {"input_points", "plane_points", "unselected_points", "levels"}
    assert len(out["levels"]) == 2
    n_unsel = out["unselected_points"]
    for d, lvl in enumerate(out["levels"], start=1):
        assert 0 < lvl["points"] - n_unsel < out["plane_points"] / (1.6 ** d)
        assert tio.load_gaussian_cloud(lvl["path"], device="cpu").num_points == lvl["points"]
