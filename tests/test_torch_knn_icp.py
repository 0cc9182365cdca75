"""Torch port vs JAX package: neighbor search, voxel downsampling, normals,
the four ICP variants and multiscale registration.

The same seeded numpy inputs go through both packages on the CPU. Tolerances:
d2 within 1e-6 relative, indices equal except at exact ties (detected and
excused); grid against brute within the gate as tests/test_icp.py; voxel
points within 1e-6 (same count and order); normals |n . n_jax| >= 1 - 1e-5
with the same sign wherever |n_z| > 1e-3; ICP poses within 1e-5 of JAX's
after a fixed budget, fitness and RMSE within 1e-6, and the f64 goldens at
tests/test_goldens.py's tolerances through both correspondence paths;
multiscale within 1e-4 of JAX's.
"""

import os
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gaussiansplattingregistration_tpu.models import parameters as JP
from gaussiansplattingregistration_tpu.models.point_cloud import PointCloud as JPointCloud
from gaussiansplattingregistration_tpu.ops import icp as jicp
from gaussiansplattingregistration_tpu.ops import knn as jknn
from gaussiansplattingregistration_tpu.ops import normals as jnormals
from gaussiansplattingregistration_tpu.ops import voxel as jvoxel
from gaussiansplattingregistration_tpu.pipelines import multiscale as jms
from gaussiansplattingregistration_tpu_torch.models import parameters as P
from gaussiansplattingregistration_tpu_torch.models.point_cloud import PointCloud
from gaussiansplattingregistration_tpu_torch.ops import icp, knn, normals, voxel
from gaussiansplattingregistration_tpu_torch.pipelines import multiscale
from gaussiansplattingregistration_tpu_torch.utils import profiling
from tests.test_goldens import _pose_err
from tests.test_icp import gt_transform, make_surface_cloud
from port_scenes import two_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_torch_threads")

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
VARIANTS = ["ICP_POINT_TO_POINT", "ICP_POINT_TO_PLANE", "ICP_COLOR", "ICP_GENERAL"]


def t(a):
    return None if a is None else torch.tensor(np.asarray(a, np.float32))


def clouds(points, colors=None, normals=None):
    """The same arrays as a JAX and a port PointCloud."""
    j = JPointCloud(points=jnp.asarray(points),
                    colors=None if colors is None else jnp.asarray(colors),
                    normals=None if normals is None else jnp.asarray(normals))
    return j, PointCloud(points=t(points), colors=t(colors), normals=t(normals))


def assert_neighbors_match(query, data, d2, idx, jd2, jidx):
    """d2 within 1e-6 relative; an index may differ only where both
    neighbors are at exactly the same distance (the brute form's f32 value).
    For D > 4 both packages use the Gram form, whose cancellation leaves
    ~1e-6 of |q|^2 + |d|^2: distances, and the ties excused, are held to
    that instead."""
    jd2, jidx = np.asarray(jd2), np.asarray(jidx).astype(np.int64)
    scale = 0.0 if query.shape[1] <= 4 else 1e-6 * float(
        np.max(np.sum(query ** 2, 1)) + np.max(np.sum(data ** 2, 1)))
    np.testing.assert_allclose(d2.numpy(), jd2, rtol=1e-6, atol=max(scale, 1e-12))
    idx = idx.numpy().reshape(len(query), -1)
    jidx = jidx.reshape(len(query), -1)
    rows, cols = np.nonzero(idx != jidx)
    q, d = t(query), t(data)
    for r, c in zip(rows, cols):
        pair = knn._pairwise_sqdist(q[r:r + 1], d[[int(idx[r, c]), int(jidx[r, c])]])[0]
        assert abs(float(pair[0] - pair[1])) <= scale, (r, c, pair)


@pytest.mark.parametrize("dim", [3, 33])
def test_knn_and_nearest_neighbor_match_jax(rng, dim):
    data = rng.uniform(-1, 1, (1500, dim)).astype(np.float32)
    data[7] = data[8]                                     # an exact tie
    query = np.concatenate([rng.uniform(-1, 1, (300, dim)), data[:20]]).astype(np.float32)
    d2, idx = knn.knn(t(query), t(data), k=8, block_size=37)
    jd2, jidx = jknn.knn(jnp.asarray(query), jnp.asarray(data), k=8)
    assert idx.dtype == torch.int64 and d2.shape == (320, 8)
    assert_neighbors_match(query, data, d2, idx, jd2, jidx)
    d2, idx = knn.nearest_neighbor(t(query), t(data))
    jd2, jidx = jknn.nearest_neighbor(jnp.asarray(query), jnp.asarray(data))
    assert_neighbors_match(query, data, d2, idx, jd2, jidx)
    if dim == 3:   # min keeps the first of tied neighbors, as argmin does
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    d2, idx, valid = knn.hybrid_search(t(query), t(data), 0.2, k=8)
    jd2, jidx, jvalid = jknn.hybrid_search(jnp.asarray(query), jnp.asarray(data), 0.2, k=8)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


def test_knn_block_budget_bounds_the_tile():
    """Rows per block keep the [B, N] f32 tile within BLOCK_BYTES."""
    assert knn._rows_per_block(100_000, None) * 100_000 * 4 <= knn.BLOCK_BYTES
    assert knn._rows_per_block(10**10, None) == 1
    assert knn._rows_per_block(100, 64) == 64


def _like(device: str, rows: int, dim: int, dtype=torch.float32):
    """What the dispatch rule reads of an input: device, dtype and shape."""
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype, shape=(rows, dim))


@pytest.mark.parametrize("device, dim, k, dtype, kernel", [
    ("cuda", 3, 1, torch.float32, True),       # ICP's correspondences
    ("cuda", 3, 32, torch.float32, True),      # HEM's candidates
    ("cuda", 3, 128, torch.float32, True),
    ("cuda", 1, 20, torch.float32, True),
    ("cuda", 4, 30, torch.float32, True),
    ("cuda", 5, 1, torch.float32, False),      # the Gram form
    ("cuda", 33, 1, torch.float32, False),     # FPFH feature matching
    ("cuda", 3, 129, torch.float32, False),    # past the kernel's k-list
    ("cuda", 3, 0, torch.float32, False),
    ("cuda", 3, 32, torch.float64, False),
    ("cpu", 3, 32, torch.float32, False),      # the plain form
    ("cpu", 3, 1, torch.float32, False),
])
def test_kernel_dispatch_rule(device, dim, k, dtype, kernel):
    """The brute search runs on csrc/knn_brute.cu exactly for a CUDA
    float32 query of D <= 4 and 1 <= k <= KERNEL_MAX_K."""
    assert knn.KERNEL_MAX_K == 128
    assert knn._takes_kernel(_like(device, 10, dim, dtype), _like(device, 500, dim, dtype),
                             k) is kernel


@pytest.mark.parametrize("case", ["empty_query", "k_above_n", "k_equals_n", "data_float64",
                                  "data_on_another_card", "data_on_cpu", "dims_differ"])
def test_kernel_dispatch_rule_reads_the_data_too(case):
    """An empty query, k > N, and data that the kernel cannot take keep the
    plain form, with its results (an empty query gives empty [0, k]
    outputs) and its errors; k = N is the kernel's."""
    query, data, k = _like("cuda:0", 10, 3), _like("cuda:0", 40, 3), 32
    if case == "empty_query":
        query = _like("cuda:0", 0, 3)
    elif case == "k_above_n":
        data = _like("cuda:0", 20, 3)
    elif case == "k_equals_n":
        data = _like("cuda:0", 32, 3)
    elif case == "data_float64":
        data = _like("cuda:0", 40, 3, torch.float64)
    elif case == "data_on_another_card":
        data = _like("cuda:1", 40, 3)
    elif case == "data_on_cpu":
        data = _like("cpu", 40, 3)
    else:
        data = _like("cuda:0", 40, 4)
    assert knn._takes_kernel(query, data, k) is (case == "k_equals_n")


@pytest.mark.parametrize("search", ["knn", "hybrid", "nearest"])
def test_an_empty_query_gives_empty_outputs_past_n(monkeypatch, search):
    """Q = 0 with N < k gives empty [0, k] outputs, as the plain form
    always did, and never reaches the kernel's wrapper."""
    def no_kernel(*_a, **_k):
        raise AssertionError("the kernel's wrapper was called")

    monkeypatch.setattr(knn, "knn_brute", no_kernel)
    query, data = torch.zeros((0, 3)), torch.ones((5, 3))
    if search == "knn":
        out = knn.knn(query, data, 8)
    elif search == "hybrid":
        out = knn.hybrid_search(query, data, 0.5, 8)
    else:
        out = knn.nearest_neighbor(query, data)
    want = (0,) if search == "nearest" else (0, 8)
    assert all(tuple(x.shape) == want for x in out)
    assert out[1].dtype == torch.int64


@pytest.mark.parametrize("n_query, n_data, k, wave, splits", [
    (66_500, 200_000, 32, 528, 1),      # HEM's level 0: 520 blocks fill the wave
    (68_000, 68_000, 1, 528, 3),        # ICP's level 1: 133 blocks of 512 queries
    (8_700, 8_700, 1, 528, 16),         # ICP's level 3: the chunk count binds
    (8_700, 100_000, 1, 528, 31),       # 17 blocks: the wave binds
    (7, 5000, 30, 1056, 9),             # one block: the chunk count binds
    (7, 1_000_000, 30, 1056, 64),       # one block: at most 64 ranges
    (1000, 511, 32, 1056, 1),           # less than one chunk of data
])
def test_split_plan(n_query, n_data, k, wave, splits):
    """The ranges of the data a search splits into: one wave of blocks,
    a staged chunk a range at least, 64 at most."""
    assert knn._splits(n_query, n_data, k, wave) == splits


@pytest.mark.parametrize("dim, k", [(3, 8), (3, 1), (33, 4), (3, 129)])
def test_cpu_tensors_take_the_plain_path(rng, monkeypatch, dim, k):
    """CPU tensors, D > 4 and k > 128 never reach the kernel's wrapper: the
    public functions give the plain form's results, and no kernel pair is
    counted."""
    def no_kernel(*_a, **_k):
        raise AssertionError("the kernel's wrapper was called")

    monkeypatch.setattr(knn, "knn_brute", no_kernel)
    data = t(rng.uniform(-1, 1, (400, dim)))
    query = t(rng.uniform(-1, 1, (50, dim)))
    profiling.reset()
    with profiling.recording():
        d2, idx = knn.knn(query, data, k)
        hd2, hidx, valid = knn.hybrid_search(query, data, 0.5, k)
        nd2, nidx = knn.nearest_neighbor(query, data)
    pd2, pidx = knn._knn_blocked(query, data, k, None)
    assert torch.equal(d2, pd2) and torch.equal(idx, pidx)
    assert torch.equal(hd2, pd2) and torch.equal(hidx, pidx)
    assert torch.equal(valid, pd2 <= 0.25)
    pnd2, pnidx = knn._nearest_blocked(query, data, None)
    assert torch.equal(nd2, pnd2) and torch.equal(nidx, pnidx)
    counters = profiling.snapshot()["counters"]
    profiling.reset()
    assert counters["knn.pairs"] == 3 * 50 * 400
    assert "knn.kernel_pairs" not in counters


@pytest.mark.parametrize("case, match", [
    ("float64", "float32"),
    ("five_coords", r"\[rows, 1..4\]"),
    ("three_dims", r"\[rows, 1..4\]"),
    ("strided", "contiguous"),
    ("cpu", "CUDA"),
])
def test_knn_brute_rejects_bad_inputs(case, match):
    """The kernel's wrapper checks dtype, shape, contiguity and device
    before it loads or launches anything."""
    good = torch.zeros((64, 3))
    bad = {"float64": torch.zeros((64, 3), dtype=torch.float64),
           "five_coords": torch.zeros((64, 5)),
           "three_dims": torch.zeros((4, 16, 3)),
           "strided": torch.zeros((3, 64)).T,
           "cpu": good}[case]
    before = knn.knn_brute.launches
    for query, data in ((bad, good), (good, bad)):
        with pytest.raises(ValueError, match=match):
            knn.knn_brute(query, data, 8)
    assert knn.knn_brute.launches == before


def test_plain_path_order_on_exact_ties(rng):
    """What the plain form already gives on constructed ties (each point
    three times, and HEM's dead rows at 1e12): the distances of the
    (d2, index) order bit for bit, ascending; each index at its slot's
    distance; and for k = 1, in `nearest_neighbor` and in `knn`, the
    lowest index of a tie, the kernel's rule."""
    pts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    far = pts.copy()
    far[20:] = 1e12
    for data in (np.concatenate([pts, pts, pts]), far):
        q, d = t(pts[:60]), t(data)
        full = knn._pairwise_sqdist(q, d)
        order = torch.sort(full, dim=1, stable=True)
        for k in (1, 2, 5, 32):
            d2, idx = knn.knn(q, d, k)
            assert torch.equal(d2.view(torch.int32), order.values[:, :k].view(torch.int32))
            assert bool((d2[:, 1:] >= d2[:, :-1]).all())
            assert torch.equal(torch.gather(full, 1, idx), d2)
            if k == 1:
                assert torch.equal(idx, order.indices[:, :1])
        nd2, nidx = knn.nearest_neighbor(q, d)
        assert torch.equal(nidx, order.indices[:, 0])
        assert torch.equal(nd2, order.values[:, 0])
    # Every query meets itself three times: the first copy wins.
    assert torch.equal(knn.nearest_neighbor(t(pts), t(np.concatenate([pts] * 3)))[1],
                       torch.arange(300))


def _grid(points, gate):
    plan = jknn.grid_nn_plan(points, gate)
    assert plan is not None
    origin, inv_cell, dims, max_occ = plan
    port_plan = knn.grid_nn_plan(t(points), gate)
    np.testing.assert_array_equal(port_plan[0], origin)
    assert port_plan[1:] == (inv_cell, dims, max_occ)
    table = knn.build_grid_table(t(points), torch.ones(len(points), dtype=torch.bool),
                                 origin, inv_cell, *dims, max_occ)
    jtable = jknn.build_grid_table(jnp.asarray(points), jnp.ones(len(points), bool),
                                   jnp.asarray(origin), jnp.asarray(inv_cell), *dims, max_occ)
    np.testing.assert_array_equal(table.numpy(), np.asarray(jtable))
    return plan, table, jtable


def test_grid_nn_boundary_cases(rng):
    """tests/test_icp.py's cases (queries outside the grid, empty
    neighborhoods, duplicate points, a dead row): grid against brute within
    the gate, and against JAX's grid."""
    tgt = rng.uniform(0, 1, size=(500, 3)).astype(np.float32)
    tgt[10] = tgt[11]
    gate = 0.08
    (origin, inv_cell, dims, max_occ), table, jtable = _grid(tgt, gate)
    valid = np.ones(500, bool)
    valid[3] = False
    dead = knn.build_grid_table(t(tgt), torch.as_tensor(valid), origin, inv_cell, *dims, max_occ)
    jdead = jknn.build_grid_table(jnp.asarray(tgt), jnp.asarray(valid), jnp.asarray(origin),
                                  jnp.asarray(inv_cell), *dims, max_occ)
    np.testing.assert_array_equal(dead.numpy(), np.asarray(jdead))
    q = np.concatenate([
        tgt[:100] + rng.normal(0, 0.01, (100, 3)).astype(np.float32),
        np.array([[5.0, 5.0, 5.0], [-3.0, 0.5, 0.5]], np.float32),
    ])
    w = 27 * max_occ
    d2g, idxg = knn.grid_nearest_neighbor(t(q), table, origin, inv_cell, *dims, w)
    d2b, idxb = knn.nearest_neighbor(t(q), t(tgt))
    gated = (d2b <= gate * gate).numpy()
    np.testing.assert_allclose(d2g.numpy()[gated], d2b.numpy()[gated], rtol=1e-6, atol=1e-12)
    np.testing.assert_array_equal(idxg.numpy()[gated], idxb.numpy()[gated])
    assert np.all(d2g.numpy()[~gated] > gate * gate)
    jd2, jidx = jknn.grid_nearest_neighbor(jnp.asarray(q), jtable, jnp.asarray(origin),
                                           jnp.asarray(inv_cell), *dims, w)
    np.testing.assert_array_equal(idxg.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(d2g.numpy(), np.asarray(jd2), rtol=1e-6)


def test_grid_topk_matches_brute_within_radius(rng):
    """The in-radius neighbor set of grid_topk equals brute knn's, and the
    whole output equals JAX's grid_topk."""
    pts = rng.uniform(-1, 1, size=(1500, 3)).astype(np.float32)
    r = 0.12
    (origin, inv_cell, dims, _), table, jtable = _grid(pts, r)
    d2g, idxg = knn.grid_topk(t(pts), table, origin, inv_cell, dims, 8)
    d2b, idxb = knn.knn(t(pts), t(pts), k=8)
    for i in range(len(pts)):
        want = {int(j) for j, d in zip(idxb[i], d2b[i]) if d <= r * r}
        got = {int(j) for j, d in zip(idxg[i], d2g[i]) if d <= r * r}
        assert want == got, (i, want, got)
    jd2, jidx = jknn.grid_topk(jnp.asarray(pts), jtable, jnp.asarray(origin),
                               jnp.asarray(inv_cell), jnp.asarray(dims, jnp.int32), 8)
    inside = np.asarray(jd2) <= r * r
    np.testing.assert_array_equal(idxg.numpy()[inside], np.asarray(jidx)[inside])
    np.testing.assert_allclose(d2g.numpy(), np.asarray(jd2), rtol=1e-6)


@pytest.mark.parametrize("with_normals", [False, True])
def test_voxel_downsample_matches_jax(rng, with_normals):
    pts = rng.uniform(0, 1, size=(1000, 3)).astype(np.float32)
    nrm = rng.normal(size=(1000, 3)).astype(np.float32) if with_normals else None
    jpc, pc = clouds(pts, colors=pts[:, ::-1].copy(), normals=nrm)
    for size in (0.25, 0.07):
        got, want = voxel.voxel_downsample(pc, size), jvoxel.voxel_downsample(jpc, size)
        assert got.num_points == want.num_points
        for a, b in ((got.points, want.points), (got.colors, want.colors),
                     (got.normals, want.normals)):
            if b is None:
                assert a is None
            else:
                np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    assert voxel.voxel_downsample(pc, 0.07, max_voxels=50).num_points == 50


@pytest.mark.parametrize("radius", [np.inf, 0.15])
def test_normals_match_jax(rng, radius):
    """Held where the normal is defined: points whose in-radius
    neighborhood covariance (f64) has its smallest eigenvalue apart from the
    next, by 1% of the largest; at the cloud's edge a small radius leaves
    some points two or three collinear neighbors."""
    pts, _ = make_surface_cloud(rng, n=600)
    got = normals.estimate_normals(t(pts), k=20, radius=radius).numpy()
    want = np.asarray(jnormals.estimate_normals(jnp.asarray(pts), k=20, radius=radius))
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    d2, idx = knn.knn(t(pts), t(pts), k=20)
    nb = np.where((d2.numpy() <= radius * radius)[..., None], pts[idx.numpy()], np.nan)
    centered = nb - np.nanmean(nb, axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", np.nan_to_num(centered).astype(np.float64),
                    np.nan_to_num(centered))
    lam = np.linalg.eigvalsh(cov)
    defined = lam[:, 1] - lam[:, 0] > 1e-2 * lam[:, 2]
    assert defined.mean() > 0.9
    assert np.abs(np.sum(got * want, axis=1))[defined].min() >= 1 - 1e-5
    tilted = defined & (np.abs(want[:, 2]) > 1e-3)
    np.testing.assert_array_equal(np.sign(got[tilted, 2]), np.sign(want[tilted, 2]))


def test_robust_weights_match_jax():
    r = np.linspace(-2.5, 2.5, 41).astype(np.float32)
    for kind in P.KernelLossFunctionType:
        for k in (0.0, 0.3, 1.0):
            got = icp.robust_weight(kind, t(r), k).numpy()
            want = jicp.robust_weight(JP.KernelLossFunctionType[kind.name], jnp.asarray(r), k)
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-7)


def test_gicp_covariances_and_color_gradients_match_jax(rng):
    pts, colors = make_surface_cloud(rng, n=400)
    nrm = np.asarray(jnormals.estimate_normals(jnp.asarray(pts)))
    got = icp.gicp_regularized_covariances(t(pts), None).numpy()
    want = np.asarray(jicp.gicp_regularized_covariances(jnp.asarray(pts), None))
    np.testing.assert_allclose(got, want, atol=1e-5)
    inten = colors.mean(axis=1)
    got = icp.compute_color_gradients(t(pts), t(nrm), t(inten)).numpy()
    want = np.asarray(jicp.compute_color_gradients(jnp.asarray(pts), jnp.asarray(nrm),
                                                   jnp.asarray(inten)))
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def _icp_pair(rng, scene):
    pts, colors = make_surface_cloud(rng)
    T_gt = gt_transform(0.05 if scene == "outliers" else 0.08)
    src = ((pts - T_gt[:3, 3]) @ T_gt[:3, :3]).astype(np.float32)
    if scene == "outliers":
        src[:30] += rng.normal(scale=0.5, size=(30, 3)).astype(np.float32)
    return clouds(src, colors), clouds(pts, colors)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("scene", ["clean", "outliers"])
def test_icp_variants_match_jax(rng, variant, scene):
    """A fixed budget of 12 iterations (no early exit), then the default
    criteria; with a Tukey kernel on the outlier scene."""
    (jsrc, src), (jtgt, tgt) = _icp_pair(rng, scene)
    kernel = "TUKEY" if scene == "outliers" else "NONE"
    init = np.eye(4)
    init[:3, 3] = [0.01, -0.02, 0.0]
    for rel in (0.0, 1e-6):
        kw = dict(max_correspondence=0.5, max_iteration=12, relative_fitness=rel,
                  relative_rmse=rel, k_value=0.1 if scene == "outliers" else 0.0)
        got = icp.icp(src, tgt, P.LocalRegistrationParams(
            registration_type=P.LocalRegistrationType[variant],
            rejection_type=P.KernelLossFunctionType[kernel], **kw), init_transform=init)
        want = jicp.icp(jsrc, jtgt, JP.LocalRegistrationParams(
            registration_type=JP.LocalRegistrationType[variant],
            rejection_type=JP.KernelLossFunctionType[kernel], **kw), init_transform=init)
        np.testing.assert_allclose(got.transformation, want.transformation, atol=1e-5)
        assert abs(got.fitness - want.fitness) <= 1e-6
        assert abs(got.inlier_rmse - want.inlier_rmse) <= 1e-6
        assert (got.num_iterations, got.converged) == (want.num_iterations, want.converged)


def test_icp_grid_matches_brute_and_jax(rng):
    """tests/test_icp.py's volumetric scene: the grid path reproduces the
    brute sweep exactly, and both match JAX."""
    tgt_pts = rng.uniform(-1, 1, size=(2000, 3)).astype(np.float32)
    T_off = np.asarray(gt_transform(0.03))
    src_pts = (tgt_pts @ T_off[:3, :3].T + T_off[:3, 3]).astype(np.float32)
    (jsrc, src), (jtgt, tgt) = clouds(src_pts), clouds(tgt_pts)
    params = dict(max_correspondence=0.2, max_iteration=15, relative_fitness=0.0,
                  relative_rmse=0.0)
    r_b = icp.icp(src, tgt, P.LocalRegistrationParams(**params), correspondence="brute")
    r_g = icp.icp(src, tgt, P.LocalRegistrationParams(**params), correspondence="grid")
    r_s = icp.icp(src, tgt, P.LocalRegistrationParams(**params), correspondence="grid",
                  shape_bucket=True)
    np.testing.assert_array_equal(r_s.transformation, r_g.transformation)
    np.testing.assert_allclose(r_g.transformation, r_b.transformation, atol=1e-6)
    assert r_g.fitness == r_b.fitness
    np.testing.assert_allclose(r_g.inlier_rmse, r_b.inlier_rmse, rtol=1e-6)
    want = jicp.icp(jsrc, jtgt, JP.LocalRegistrationParams(**params), correspondence="grid")
    np.testing.assert_allclose(r_g.transformation, want.transformation, atol=1e-5)
    assert abs(r_g.fitness - want.fitness) <= 1e-6
    with pytest.raises(ValueError, match="correspondence mode"):
        icp.icp(src, tgt, P.LocalRegistrationParams(**params), correspondence="kd")


def test_correspondence_plan_auto_thresholds(rng):
    """"auto" keeps brute below Q * N = 5e8 and where N / W < 40."""
    small = PointCloud(points=t(rng.uniform(-1, 1, (2000, 3))))
    assert icp.correspondence_plan(small, small, 0.1) is None
    assert icp.correspondence_plan(small, small, 0.1, "grid") is not None
    big = PointCloud(points=torch.zeros((30_000, 3)))
    assert icp.correspondence_plan(big, big, 0.1) is None   # one cell holds all


@pytest.mark.parametrize("corr", ["brute", "grid"])
@pytest.mark.parametrize("variant", ["point_to_point", "point_to_plane"])
def test_icp_matches_golden(corr, variant):
    g = np.load(os.path.join(DATA, "golden_icp.npz"))
    src = PointCloud(points=t(g["source"]))
    tgt = PointCloud(points=t(g["target"]), normals=t(g["target_normals"]))
    rt = (P.LocalRegistrationType.ICP_POINT_TO_POINT if variant == "point_to_point"
          else P.LocalRegistrationType.ICP_POINT_TO_PLANE)
    res = icp.icp(src, tgt, P.LocalRegistrationParams(
        registration_type=rt, max_correspondence=float(g["max_correspondence"]),
        max_iteration=int(g["max_iteration"]), relative_fitness=0.0, relative_rmse=0.0,
    ), correspondence=corr)
    key = "pp" if variant == "point_to_point" else "pl"
    np.testing.assert_allclose(res.transformation, g[f"T_{variant}"], atol=5e-5)
    np.testing.assert_allclose(res.transformation, g["T_true"], atol=5e-5)
    np.testing.assert_allclose(res.fitness, g[f"fitness_{key}"], atol=1e-6)
    assert res.inlier_rmse < 1e-4


@pytest.mark.parametrize("corr", ["brute", "grid"])
@pytest.mark.parametrize("variant", ["colored", "gicp"])
def test_icp_variants_match_golden(corr, variant):
    g = np.load(os.path.join(DATA, "golden_icp_variants.npz"))
    intens = lambda a: np.repeat(np.asarray(a, np.float32)[:, None], 3, 1)  # noqa: E731
    colored = variant == "colored"
    src = PointCloud(points=t(g["source"]),
                     colors=t(intens(g["source_intensity"])) if colored else None)
    tgt = PointCloud(points=t(g["target"]), normals=t(g["target_normals"]),
                     colors=t(intens(g["target_intensity"])) if colored else None)
    rt = P.LocalRegistrationType.ICP_COLOR if colored else P.LocalRegistrationType.ICP_GENERAL
    res = icp.icp(src, tgt, P.LocalRegistrationParams(
        registration_type=rt, max_correspondence=float(g["max_correspondence"]),
        max_iteration=int(g["max_iteration"]), relative_fitness=0.0, relative_rmse=0.0,
    ), correspondence=corr)
    ang, trn = _pose_err(res.transformation, g[f"T_{variant}"])
    assert ang < 2e-3 and trn < 2e-3, (ang, trn)
    np.testing.assert_allclose(res.fitness, g[f"fitness_{variant}"], atol=5e-3)
    np.testing.assert_allclose(res.inlier_rmse, g[f"rmse_{variant}"], rtol=0.05)


@pytest.mark.parametrize("corr", ["auto", "grid"])
def test_multiscale_voxel_matches_jax(rng, corr):
    pts, _ = make_surface_cloud(rng, n=800)
    xi = np.array([0.08, -0.05, 0.06, 0.1, -0.08, 0.12], np.float32)
    from gaussiansplattingregistration_tpu.ops import se3 as jse3

    T_gt = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    (jsrc, src), (jtgt, tgt) = clouds(((pts - T_gt[:3, 3]) @ T_gt[:3, :3]).astype(np.float32)), \
        clouds(pts)
    kw = dict(voxel_values=[0.3, 0.15, 0.05], iter_values=[30, 20, 15])
    got = multiscale.multiscale_voxel_registration(
        src, tgt, P.MultiScaleRegistrationParams(**kw), correspondence=corr)
    want = jms.multiscale_voxel_registration(
        jsrc, jtgt, JP.MultiScaleRegistrationParams(**kw), correspondence=corr)
    np.testing.assert_allclose(got.transformation, want.transformation, atol=1e-4)
    assert abs(got.fitness - want.fitness) <= 1e-4


def test_multiscale_mixture_and_sparse_bootstrap_match_jax(rng):
    pts, colors = make_surface_cloud(rng, n=600)
    T_gt = np.asarray(gt_transform(0.06))
    (jsrc, src), (jtgt, tgt) = clouds(((pts - T_gt[:3, 3]) @ T_gt[:3, :3]).astype(np.float32),
                                      colors), clouds(pts, colors)

    def levels(pc, select):
        return [pc, select(pc, np.arange(0, 600, 2)), select(pc, np.arange(0, 600, 4))]

    kw = dict(voxel_values=[0.3, 0.15, 0.08], iter_values=[30, 20, 15])
    got = multiscale.multiscale_mixture_registration(
        levels(src, lambda pc, i: pc.select(torch.as_tensor(i))),
        levels(tgt, lambda pc, i: pc.select(torch.as_tensor(i))),
        P.MultiScaleRegistrationParams(**kw))
    want = jms.multiscale_mixture_registration(
        levels(jsrc, lambda pc, i: pc.select(jnp.asarray(i))),
        levels(jtgt, lambda pc, i: pc.select(jnp.asarray(i))),
        JP.MultiScaleRegistrationParams(**kw))
    np.testing.assert_allclose(got.transformation, want.transformation, atol=1e-4)

    boot = dict(use_corresponding_pc=True, voxel_values=[0.3], iter_values=[10])
    got = multiscale.multiscale_voxel_registration(
        src, tgt, P.MultiScaleRegistrationParams(**boot), sparse_source=src.select(
            torch.arange(0, 600, 3)), sparse_target=tgt.select(torch.arange(0, 600, 3)))
    want = jms.multiscale_voxel_registration(
        jsrc, jtgt, JP.MultiScaleRegistrationParams(**boot), sparse_source=jsrc.select(
            jnp.arange(0, 600, 3)), sparse_target=jtgt.select(jnp.arange(0, 600, 3)))
    np.testing.assert_allclose(got.transformation, want.transformation, atol=1e-4)


def test_multiscale_validation():
    pc = PointCloud(points=torch.zeros((10, 3)))
    with pytest.raises(ValueError, match="equal length"):
        multiscale.multiscale_voxel_registration(
            pc, pc, P.MultiScaleRegistrationParams(voxel_values=[0.1], iter_values=[10, 20]))
    with pytest.raises(ValueError, match="at least one scale"):
        multiscale.multiscale_voxel_registration(
            pc, pc, P.MultiScaleRegistrationParams(voxel_values=[], iter_values=[]))
    with pytest.raises(ValueError, match="mixture levels"):
        multiscale.multiscale_mixture_registration(
            [pc], [pc], P.MultiScaleRegistrationParams(voxel_values=[0.1, 0.05],
                                                       iter_values=[5, 5]))
