"""Torch port vs JAX package: the HEM downsampler and its native bridge.

`jax.random` draws cannot be reproduced in torch, so one level is compared
with injected parent flags (tests/test_native_hem.py's setup): JAX and the
port on the same state give the same alive slots and values within 1e-5
(f32 sums in another order), and the native library through the port's
bridge gives the same mixture at test_native_hem's tolerances. The rest are
tests/test_hem.py's invariants on the port itself: shrinking counts, weight
conservation, PSD covariances, extent, seed determinism on the CPU, grid
against global search.
"""

import dataclasses
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from gaussiansplattingregistration_tpu.models.parameters import (
    GaussianMixtureParams as JGaussianMixtureParams,
)
from gaussiansplattingregistration_tpu.ops import hem as jhem
from gaussiansplattingregistration_tpu.ops import knn as jknn
from gaussiansplattingregistration_tpu.ops import math3d as jmath3d
from gaussiansplattingregistration_tpu_torch.models.gaussian_cloud import GaussianCloud
from gaussiansplattingregistration_tpu_torch.models.parameters import GaussianMixtureParams
from gaussiansplattingregistration_tpu_torch.ops import hem, knn, math3d
from tests.conftest import make_random_cloud
from tests.test_hem import make_dense_cloud
from port_scenes import two_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_torch_threads")

FIELDS = ("mean", "color", "cov", "opacity", "weight", "features", "nvar")


def port_cloud(jcloud) -> GaussianCloud:
    """The JAX cloud's arrays, its covariance cache included, on the CPU."""
    d = jcloud.to_numpy_dict()
    return GaussianCloud.create(sh_degree=jcloud.sh_degree, device="cpu",
                                covariance=np.asarray(jcloud.get_covariance()), **d)


def states(jcloud, flags):
    """The level-0 state of test_native_hem (injected flags) for both."""
    n = len(jcloud)
    arrays = dict(
        mean=np.asarray(jcloud.xyz, np.float32), color=np.asarray(jcloud.get_colors, np.float32),
        cov=np.asarray(jcloud.get_covariance(), np.float32),
        opacity=np.asarray(jcloud.get_opacity[:, 0], np.float32),
        weight=np.ones(n, np.float32),
        features=np.asarray(jcloud.features_rest.reshape(n, -1), np.float32))
    arrays["nvar"] = jhem._initial_nvar(arrays["cov"])
    masks = dict(is_parent=flags.astype(bool), alive=np.ones(n, bool))
    js = jhem.MixtureState(**{k: jnp.asarray(v) for k, v in {**arrays, **masks}.items()})
    ts = hem.MixtureState(**{k: torch.tensor(v) for k, v in {**arrays, **masks}.items()})
    return arrays, js, ts


def generator(seed=0):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("k, budget", [(256, None), (32, None), (32, 64)])
def test_level_with_injected_flags_matches_jax(rng, k, budget):
    """K=256 (exact on 300 points), K=32 (truncated candidate lists) and a
    parent budget that overflows (the parents past it are orphaned)."""
    jcloud = make_dense_cloud(rng, n=300)
    flags = (np.random.default_rng(7).random(300) < 1.0 / 3.0).astype(np.uint8)
    _, js, ts = states(jcloud, flags)
    jout, jstats = jhem.hem_cluster_level(jax.random.PRNGKey(0), js, 3.0, 3.0, 2.5, 1.0,
                                          max_children=k, with_stats=True,
                                          max_parent_slots=budget)
    out, stats = hem.hem_cluster_level(generator(), ts, 3.0, 3.0, 2.5, 1.0, max_children=k,
                                       with_stats=True, max_parent_slots=budget)
    assert stats == {key: int(v) for key, v in jstats.items()}
    if budget:
        assert stats["parent_overflow"] > 0
    alive = np.asarray(jout.alive)
    np.testing.assert_array_equal(out.alive.numpy(), alive)
    for f in FIELDS:
        want = np.asarray(getattr(jout, f))[alive]
        np.testing.assert_allclose(getattr(out, f).numpy()[alive], want,
                                   rtol=1e-5, atol=1e-5 * max(np.abs(want).max(), 1e-3))


def test_grid_level_matches_jax(rng):
    """The 27-cell grid candidate search, planned and built by each package
    from the same state, gives JAX's level."""
    jcloud = make_dense_cloud(rng, n=600)
    flags = (np.random.default_rng(8).random(600) < 1.0 / 3.0).astype(np.uint8)
    arrays, js, ts = states(jcloud, flags)
    plan = hem._plan_level_grid(ts, 3.0)
    jplan = jhem._plan_level_grid(js, 3.0)
    assert plan is not None and plan[1:] == jplan[1:]
    origin, inv_cell, dims, max_occ = plan
    table = knn.build_grid_table(ts.mean, ts.alive, origin, inv_cell, *dims, max_occ)
    jtable = jknn.build_grid_table(js.mean, js.alive, jnp.asarray(origin),
                                   jnp.asarray(inv_cell), *dims, max_occ)
    jout = jhem.hem_cluster_level(
        jax.random.PRNGKey(0), js, 3.0, 3.0, 2.5, 1.0, use_grid=True, grid_table=jtable,
        grid_origin=jnp.asarray(origin), grid_inv_cell=jnp.asarray(inv_cell),
        grid_dims=jnp.asarray(dims, jnp.int32))
    out = hem.hem_cluster_level(generator(), ts, 3.0, 3.0, 2.5, 1.0, use_grid=True,
                                grid_table=table, grid_origin=origin, grid_inv_cell=inv_cell,
                                grid_dims=dims)
    alive = np.asarray(jout.alive)
    np.testing.assert_array_equal(out.alive.numpy(), alive)
    for f in ("mean", "weight", "cov"):
        want = np.asarray(getattr(jout, f))[alive]
        np.testing.assert_allclose(getattr(out, f).numpy()[alive], want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def _rows_in_order(a, mean):
    key = np.round(np.asarray(mean, np.float64), 4)
    return np.asarray(a)[np.lexsort((key[:, 2], key[:, 1], key[:, 0]))]


def test_level_with_injected_flags_matches_native(rng, monkeypatch, tmp_path):
    """The port's level against native/hem.cpp (exact radius search)
    through the port's bridge, built into a temporary directory; the
    tolerances of tests/test_native_hem.py."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the native library cannot be built")
    from gaussiansplattingregistration_tpu_torch.utils import native

    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    jcloud = make_dense_cloud(rng, n=300)
    flags = (np.random.default_rng(7).random(300) < 1.0 / 3.0).astype(np.uint8)
    arrays, _, ts = states(jcloud, flags)
    n_mean, _, n_cov, _, n_w, _, _ = native.hem_cluster_level_native(
        arrays["mean"], arrays["color"], arrays["cov"], arrays["opacity"], arrays["weight"],
        arrays["features"], arrays["nvar"], flags, 3.0, 2.5, 1.0)
    out = hem.hem_cluster_level(generator(), ts, 3.0, 3.0, 2.5, 1.0, max_children=256)
    alive = out.alive.numpy()
    mean = out.mean.numpy()[alive]
    assert n_mean.shape[0] == mean.shape[0]
    np.testing.assert_allclose(_rows_in_order(n_mean, n_mean), _rows_in_order(mean, mean),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(_rows_in_order(n_w, n_mean),
                               _rows_in_order(out.weight.numpy()[alive], mean),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(_rows_in_order(n_cov, n_mean),
                               _rows_in_order(out.cov.numpy()[alive], mean),
                               rtol=5e-3, atol=1e-5)


def test_native_backend_matches_jax_native_backend(rng, monkeypatch, tmp_path):
    """`create_mixture(backend="native")` draws its flags from numpy as the
    JAX package does, so both packages' native paths give the same levels."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the native library cannot be built")
    from gaussiansplattingregistration_tpu.utils import native as jnative
    from gaussiansplattingregistration_tpu_torch.utils import native

    if jnative.load_library() is None:
        pytest.skip(f"the JAX package's native library is unavailable: {jnative.build_error()}")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    jcloud = make_dense_cloud(rng, n=400)
    levels = hem.create_mixture(port_cloud(jcloud), GaussianMixtureParams(cluster_level=2),
                                seed=0, backend="native")
    want = jhem.create_mixture(jcloud, JGaussianMixtureParams(cluster_level=2), seed=0,
                               backend="native")
    assert [lvl.xyz.shape[0] for lvl in levels] == [lvl.xyz.shape[0] for lvl in want]
    for a, b in zip(levels, want):
        np.testing.assert_allclose(a.xyz, b.xyz, atol=1e-6)
        np.testing.assert_allclose(a.covariance, b.covariance, atol=1e-6)


def test_native_backend_raises_without_the_library(rng, monkeypatch):
    """No fall back to torch: a missing g++ raises."""
    from gaussiansplattingregistration_tpu_torch.utils import native

    monkeypatch.setattr(native, "BUILD_DIR", "/nonexistent-build-dir")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    cloud = port_cloud(make_dense_cloud(rng, n=50))
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        hem.create_mixture(cloud, GaussianMixtureParams(cluster_level=1), backend="native")
    with pytest.raises(ValueError, match="backend"):
        hem.create_mixture(cloud, GaussianMixtureParams(cluster_level=1), backend="jax")


def test_level_counts_shrink(rng):
    cloud = port_cloud(make_dense_cloud(rng))
    levels = hem.create_mixture(cloud, GaussianMixtureParams(cluster_level=3, hem_reduction=3.0),
                                seed=0)
    counts = [len(cloud)] + [lvl.xyz.shape[0] for lvl in levels]
    assert all(b < a for a, b in zip(counts[:-1], counts[1:])), counts
    assert counts[1] < 0.75 * counts[0] and counts[-1] < 0.4 * counts[0]


def test_weight_conservation(rng):
    cloud = port_cloud(make_dense_cloud(rng, n=300))
    g = generator()
    state = hem.init_mixture(g, cloud.xyz, cloud.get_colors, cloud.get_opacity[:, 0],
                             cloud.get_covariance(), cloud.features_rest.reshape(300, -1), 3.0)
    new = hem.hem_cluster_level(g, state, 3.0, 3.0, 2.5, 1.0)
    total_in = float(torch.sum(state.weight * state.alive))
    total_out = float(torch.sum(new.weight * new.alive))
    assert abs(total_in - total_out) / total_in < 0.02, (total_in, total_out)


def test_covariances_psd_and_in_extent(rng):
    cloud = port_cloud(make_dense_cloud(rng))
    levels = hem.create_mixture(cloud, GaussianMixtureParams(cluster_level=2), seed=1)
    lo = cloud.xyz.numpy().min(0) - 1e-4
    hi = cloud.xyz.numpy().max(0) + 1e-4
    for lvl in levels:
        eig = np.linalg.eigvalsh(math3d.unpack_symmetric(torch.as_tensor(lvl.covariance)).numpy())
        assert np.all(eig[:, 0] > -1e-8), eig.min()
        assert np.all(np.isfinite(lvl.xyz)) and np.all(np.isfinite(lvl.features))
        assert np.all(lvl.xyz >= lo) and np.all(lvl.xyz <= hi)


def test_deterministic_with_seed(rng):
    cloud = port_cloud(make_dense_cloud(rng, n=200))
    params = GaussianMixtureParams(cluster_level=2)
    l1, l2 = (hem.create_mixture(cloud, params, seed=7) for _ in range(2))
    for a, b in zip(l1, l2):
        np.testing.assert_array_equal(a.xyz, b.xyz)
        np.testing.assert_array_equal(a.covariance, b.covariance)
    other = hem.create_mixture(cloud, params, seed=8)
    assert any(a.xyz.shape != b.xyz.shape or not np.array_equal(a.xyz, b.xyz)
               for a, b in zip(l1, other))


def test_sum_per_child_is_an_ordered_sum(rng):
    """The deterministic scatter equals a float64 scatter-add to f32
    rounding, and is the same bits on every call."""
    idx = torch.as_tensor(rng.integers(0, 50, size=(40, 8)))
    val = torch.as_tensor(rng.uniform(0, 1, size=(40, 8)).astype(np.float32))
    want = np.zeros(60)
    np.add.at(want, idx.numpy().reshape(-1), val.numpy().astype(np.float64).reshape(-1))
    got = hem._sum_per_child(60, idx, val)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert torch.equal(got, hem._sum_per_child(60, idx, val))


class _LargestTensor(TorchDispatchMode):
    """Records the largest element count of any tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.numel = max(self.numel, t.numel())
        return out


@pytest.mark.parametrize("hub_entries", [1, 257, 5000])
def test_sum_per_child_skewed_in_degree(rng, hub_entries):
    """One child named by most entries (runs of 1, just past a power of
    two, and long): the sums match a float64 scatter-add, repeat bit for
    bit, and no tensor grows past max(entries, n)."""
    n = 300
    idx = np.concatenate([np.zeros(hub_entries, np.int64), rng.integers(1, n, size=900)])
    rng.shuffle(idx)
    val = rng.uniform(0, 1, size=idx.shape).astype(np.float32)
    val[rng.random(idx.shape) < 0.5] = 0.0
    want = np.zeros(n)
    np.add.at(want, idx, val.astype(np.float64))
    with _LargestTensor() as largest:
        got = hem._sum_per_child(n, torch.as_tensor(idx), torch.as_tensor(val))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6)
    assert torch.equal(got, hem._sum_per_child(n, torch.as_tensor(idx), torch.as_tensor(val)))
    assert largest.numel <= max(idx.size, n)


def test_grid_level_with_floaters_matches_jax_in_bounded_memory(rng, monkeypatch):
    """Isolated splats on a lattice around the dense cube leave most of the
    k slots of their 27-cell window empty, and every empty slot names
    child 0. The level still matches JAX's, and the per-child sum
    allocates nothing larger than its entries, however many empty slots
    child 0 collects."""
    jcloud = make_dense_cloud(rng, n=600)
    xyz = np.asarray(jcloud.xyz).copy()
    g = np.array([-3.0, -1.0, 1.0, 3.0])
    xyz[-60:] = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)[:60]
    jcloud = dataclasses.replace(jcloud, xyz=jnp.asarray(xyz))
    flags = (np.random.default_rng(9).random(600) < 1.0 / 3.0).astype(np.uint8)
    flags[-60:] = 1
    _, js, ts = states(jcloud, flags)
    plan = hem._plan_level_grid(ts, 3.0)
    assert plan is not None
    origin, inv_cell, dims, max_occ = plan
    table = knn.build_grid_table(ts.mean, ts.alive, origin, inv_cell, *dims, max_occ)
    jtable = jknn.build_grid_table(js.mean, js.alive, jnp.asarray(origin),
                                   jnp.asarray(inv_cell), *dims, max_occ)

    seen = {}
    real_sum = hem._sum_per_child

    def measured_sum(n, idx, val):
        seen["hub"] = int(torch.sum(idx == 0))
        seen["entries"] = idx.numel()
        with _LargestTensor() as largest:
            out = real_sum(n, idx, val)
        seen["largest"] = largest.numel
        return out

    monkeypatch.setattr(hem, "_sum_per_child", measured_sum)
    out = hem.hem_cluster_level(generator(), ts, 3.0, 3.0, 2.5, 1.0, use_grid=True,
                                grid_table=table, grid_origin=origin, grid_inv_cell=inv_cell,
                                grid_dims=dims)
    jout = jhem.hem_cluster_level(
        jax.random.PRNGKey(0), js, 3.0, 3.0, 2.5, 1.0, use_grid=True, grid_table=jtable,
        grid_origin=jnp.asarray(origin), grid_inv_cell=jnp.asarray(inv_cell),
        grid_dims=jnp.asarray(dims, jnp.int32))
    # 60 lone parents send ~31 empty slots each to child 0: a padded
    # [600, in-degree] buffer would be ~30x the entries.
    assert seen["hub"] > 40 * 32
    assert seen["largest"] <= max(seen["entries"], 600)
    alive = np.asarray(jout.alive)
    np.testing.assert_array_equal(out.alive.numpy(), alive)
    assert alive[-60:].all()  # the floaters pass through as merged singletons
    for f in ("mean", "weight", "cov"):
        want = np.asarray(getattr(jout, f))[alive]
        np.testing.assert_allclose(getattr(out, f).numpy()[alive], want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_grid_search_matches_global(rng):
    """The grid candidate path reproduces the global fixed-K path closely
    on a uniform scene, and `grid_search` in the stats says which ran."""
    n = 2000
    jcloud = make_random_cloud(rng, n=n, sh_degree=1, scale_range=(0.06, 0.12))
    jcloud = dataclasses.replace(jcloud, xyz=jnp.asarray(
        rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)))
    jcloud = dataclasses.replace(jcloud, covariance=jmath3d.covariance_from_scaling_rotation(
        jcloud.get_scaling, jcloud.get_rotation))
    cloud = port_cloud(jcloud)
    params = GaussianMixtureParams(cluster_level=2)
    grid, gstats = hem.create_mixture(cloud, params, seed=0, neighbor_search="grid",
                                      with_stats=True)
    glob, bstats = hem.create_mixture(cloud, params, seed=0, neighbor_search="global",
                                      with_stats=True)
    assert [s["grid_search"] for s in gstats] == [1, 1]
    assert [s["grid_search"] for s in bstats] == [0, 0]
    for g, b in zip(grid, glob):
        sg, sb = g.xyz.shape[0], b.xyz.shape[0]
        assert abs(sg - sb) <= max(0.02 * sb, 5), (sg, sb)
        np.testing.assert_allclose(g.xyz.mean(0), b.xyz.mean(0), atol=0.05)
    with pytest.raises(ValueError, match="neighbor_search"):
        hem.create_mixture(cloud, params, neighbor_search="kd")


def test_mixture_to_cloud_roundtrip_matches_jax(rng):
    """from_mixture against JAX's on the same level, and the cache
    reproducing the mixture covariance and opacity."""
    jcloud = make_dense_cloud(rng, n=200)
    level = jhem.create_mixture(jcloud, JGaussianMixtureParams(cluster_level=1), seed=3)[0]
    down = hem.mixture_levels_to_clouds([level], jcloud.sh_degree, device="cpu")[0]
    want = jhem.mixture_levels_to_clouds([level], jcloud.sh_degree)[0]
    assert down.sh_degree == jcloud.sh_degree and down.num_points == level.xyz.shape[0]
    np.testing.assert_allclose(down.get_covariance().numpy(), level.covariance,
                               rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(down.get_opacity[:, 0].numpy(), level.opacities,
                               rtol=1e-4, atol=1e-5)
    for name in ("xyz", "features_dc", "features_rest", "opacity", "scaling"):
        np.testing.assert_allclose(getattr(down, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=2e-4, err_msg=name)
    # Eigenvector signs are free (R and R diag(-1, -1, 1) are both proper),
    # so the rotations are held through the covariance they rebuild.
    rebuilt = math3d.covariance_from_scaling_rotation(down.get_scaling, down.rotation)
    np.testing.assert_allclose(rebuilt.numpy(), level.covariance, rtol=1e-3, atol=1e-6)


def test_pad_to_matches_jax(rng):
    jcloud = make_random_cloud(rng, n=10, sh_degree=1)
    padded = port_cloud(jcloud).pad_to(16)
    want = jcloud.pad_to(16)
    assert padded.num_points == 16 and port_cloud(jcloud).pad_to(4).num_points == 10
    for name in ("xyz", "features_dc", "features_rest", "opacity", "scaling", "rotation",
                 "covariance"):
        np.testing.assert_allclose(getattr(padded, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=1e-6, err_msg=name)
