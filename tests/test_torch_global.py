"""Torch port vs JAX package: FPFH, preprocessing, RANSAC and FGR.

The same seeded numpy inputs go through both packages on the CPU.
Tolerances:
- FPFH: fed the same points and normals, each 11-bin sub-histogram scaled to
  percentages of its sum, within 1e-4 absolute. The only points excused are
  those where a pair feature, the point's own or a neighbor's, lies within
  1e-5 of a bin edge (`features.near_bin_edge`); they are counted, and at
  most 1% of all points may be off by more than 1e-4.
- Preprocessing: equal downsampled points. Feature correspondences and the
  mutual mask: equal.
- One hypothesis batch with the samples `jax.random.choice` draws for the
  same key: equal fitness, rmse within 1e-5, T within 1e-5 where the
  checkers pass. A rejected hypothesis may be an ill-conditioned 3-point
  fit whose Horn power iteration amplifies rounding: within 1e-4.
- The RANSAC search with JAX's batches injected (the test replays JAX's
  split/choice sequence): the same number of hypotheses, T within 1e-4.
- The tuple test with injected triples: an equal mask; `_fgr_optimize`
  within 1e-4.
- On `golden_global.npz`, RANSAC with the port's own draws and FGR with
  JAX's seed-0 triples injected, under tests/test_goldens.py's pose-basin
  and oracle asserts; `register --method ransac|fgr` on the CPU prints the
  JAX CLI's keys.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiansplattingregistration_tpu.cli.main import build_parser as jax_parser
from gaussiansplattingregistration_tpu.models.point_cloud import PointCloud as JPointCloud
from gaussiansplattingregistration_tpu.ops import features as jfeat
from gaussiansplattingregistration_tpu.ops import global_registration as jgr
from gaussiansplattingregistration_tpu.ops import normals as jnormals
from gaussiansplattingregistration_tpu_torch.cli.main import main as port_main
from gaussiansplattingregistration_tpu_torch.models import parameters as P
from gaussiansplattingregistration_tpu_torch.models.point_cloud import PointCloud
from gaussiansplattingregistration_tpu_torch.ops import features, global_registration as gr
from tests.test_global_registration import displaced_pair, make_structured_cloud
from tests.test_goldens import _fitness_rmse_oracle, _pose_err, _voxel_downsample_oracle
from port_scenes import two_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_torch_threads")

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
CHECKERS = (("edge_length", 0.9), ("distance", 0.15))


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def percent(f):
    """Each 11-bin sub-histogram of [N, 33] features as percentages of its
    sum."""
    f = np.asarray(f, np.float64).reshape(len(f), 3, 11)
    return (f / np.maximum(f.sum(-1, keepdims=True), 1e-30) * 100.0).reshape(len(f), 33)


def near_tie_mismatches(query, data, idx_a, idx_b):
    """Rows where two nearest-neighbor searches in feature space disagree,
    asserted to be near ties: the two candidates' f64 squared distances
    within the Gram form's cancellation, 1e-6 of |q|^2 + |d|^2 (as
    tests/test_torch_knn_icp.py excuses them). Returns the rows."""
    q, d = np.asarray(query, np.float64), np.asarray(data, np.float64)
    rows = np.nonzero(np.asarray(idx_a) != np.asarray(idx_b))[0]
    scale = 1e-6 * (np.max(np.sum(q * q, 1)) + np.max(np.sum(d * d, 1)))
    for r in rows:
        da, db = (np.sum((q[r] - d[int(i[r])]) ** 2) for i in (idx_a, idx_b))
        assert abs(da - db) <= scale, (r, da, db, scale)
    return rows


def assert_fpfh_close(got, want, excused):
    """Within 1e-4 (percentage scale) except at the excused points, and at
    most 1% of the points off by more; returns the number of excused
    points."""
    err = np.abs(percent(got) - percent(want)).max(axis=1)
    bad = np.nonzero((err > 1e-4) & ~excused)[0]
    assert bad.size == 0, (bad[:10], err[bad[:10]])
    assert (err > 1e-4).sum() <= 0.01 * len(err)
    return int(excused.sum())


@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(DATA, "golden_global.npz"))


@pytest.fixture(scope="module")
def prepared(golden):
    """JAX's preprocessing of the golden pair at its voxel size and its
    mutual feature correspondences: the inputs both hypothesis searches
    share."""
    vox = float(golden["voxel_size"])
    src_down, src_f = jgr.preprocess_point_cloud(
        JPointCloud(points=jnp.asarray(golden["source"], jnp.float32)), vox)
    tgt_down, tgt_f = jgr.preprocess_point_cloud(
        JPointCloud(points=jnp.asarray(golden["target"], jnp.float32)), vox)
    corr_idx, corr_mask = jgr._feature_correspondences(src_f, tgt_f, True)
    return {"src": src_down, "tgt": tgt_down, "src_f": src_f, "tgt_f": tgt_f,
            "corr_idx": corr_idx, "corr_mask": corr_mask, "mc": float(golden["max_correspondence"])}


@pytest.mark.parametrize("n, radius, max_nn", [(1500, 0.5, 100), (600, 0.3, 30)])
def test_fpfh_matches_jax(n, radius, max_nn):
    rng = np.random.default_rng(n)
    pts = make_structured_cloud(rng, n=n)
    nrm = np.asarray(jnormals.estimate_normals(jnp.asarray(pts), k=20))
    want = np.asarray(jfeat.compute_fpfh(jnp.asarray(pts), jnp.asarray(nrm), radius=radius,
                                         max_nn=max_nn))
    got = features.compute_fpfh(t(pts), t(nrm), radius=radius, max_nn=max_nn)
    assert got.shape == (n, 33) and got.dtype == torch.float32
    excused = features.near_bin_edge(t(pts), t(nrm), radius, max_nn).numpy()
    n_excused = assert_fpfh_close(got.numpy(), want, excused)
    assert n_excused < n      # the comparison covers points
    # Raw features too, at f32's relative resolution of their size.
    ok = ~excused
    np.testing.assert_allclose(got.numpy()[ok], want[ok], rtol=1e-5, atol=1e-3)


def test_preprocess_and_correspondences_match_jax(golden):
    vox = float(golden["voxel_size"])
    outs = {}
    for name in ("source", "target"):
        jd, jf = jgr.preprocess_point_cloud(
            JPointCloud(points=jnp.asarray(golden[name], jnp.float32)), vox)
        td, tf = gr.preprocess_point_cloud(PointCloud(points=t(golden[name])), vox)
        np.testing.assert_array_equal(td.points.numpy(), np.asarray(jd.points))
        assert tf.shape == (td.num_points, 33)
        assert np.all(np.abs(np.sum(td.normals.numpy() * np.asarray(jd.normals), 1)) > 1 - 1e-5)
        excused = features.near_bin_edge(td.points, td.normals, vox * 5.0, 100).numpy()
        assert_fpfh_close(tf.numpy(), np.asarray(jf), excused)
        outs[name] = (jf, tf)
    # Both packages' correspondences on JAX's features: equal but at near
    # ties of the 33-dim Gram form; the mutual mask equal wherever both
    # directions' matches are.
    src_f, tgt_f = (np.asarray(outs[k][0]) for k in ("source", "target"))
    j_st, j_keep = jgr._feature_correspondences(jnp.asarray(src_f), jnp.asarray(tgt_f), True)
    p_st, p_keep = gr._feature_correspondences(t(src_f), t(tgt_f), True)
    assert p_st.dtype == torch.int64
    ties_st = near_tie_mismatches(src_f, tgt_f, p_st.numpy(), j_st)
    j_ts, _ = jgr._feature_correspondences(jnp.asarray(tgt_f), jnp.asarray(src_f), False)
    p_ts, all_keep = gr._feature_correspondences(t(tgt_f), t(src_f), False)
    assert bool(all_keep.all())
    ties_ts = near_tie_mismatches(tgt_f, src_f, p_ts.numpy(), j_ts)
    same = np.ones(len(src_f), bool)
    same[ties_st] = False
    same &= ~np.isin(p_st.numpy(), ties_ts)
    assert len(ties_st) + len(ties_ts) <= 3 and same.sum() > 0.99 * len(same)
    np.testing.assert_array_equal(p_keep.numpy()[same], np.asarray(j_keep)[same])


def jax_batches(seed, n_src, corr_mask, batch, ransac_n, count):
    """The sample batches JAX's RANSAC search draws: split, then choice."""
    key = jax.random.PRNGKey(seed)
    probs = corr_mask.astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    out = []
    for _ in range(count):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.choice(sub, n_src, shape=(batch, ransac_n),
                                                replace=True, p=probs)))
    return out


def port_inputs(prep):
    return (t(prep["src"].points), t(prep["tgt"].points), t(prep["src"].normals),
            t(prep["tgt"].normals), torch.tensor(np.asarray(prep["corr_idx"]), dtype=torch.int64),
            torch.tensor(np.asarray(prep["corr_mask"])))


@pytest.mark.parametrize("checkers", [CHECKERS, (("normal", 0.5),)])
def test_eval_hypotheses_matches_jax(prepared, checkers):
    prep = prepared
    key = jax.random.PRNGKey(7)
    kinds = tuple(k for k, _ in checkers)
    values = tuple(v for _, v in checkers)
    jfit, jrmse, jT = jgr._eval_hypotheses(
        key, prep["src"].points, prep["tgt"].points, prep["src"].normals, prep["tgt"].normals,
        prep["corr_idx"], prep["corr_mask"], prep["mc"], 3, 256, kinds,
        jnp.asarray(values, jnp.float32))
    probs = prep["corr_mask"].astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    samples = np.asarray(jax.random.choice(key, prep["src"].num_points, shape=(256, 3),
                                           replace=True, p=probs))
    fit, rmse, T = gr._eval_hypotheses(None, *port_inputs(prep), prep["mc"], 3, 256, kinds,
                                       values, samples=samples)
    np.testing.assert_array_equal(fit.numpy(), np.asarray(jfit))
    assert (fit.numpy() > 0).any() and (fit.numpy() < 0).any()
    np.testing.assert_allclose(rmse.numpy(), np.asarray(jrmse), atol=1e-5)
    passed = fit.numpy() >= 0
    np.testing.assert_allclose(T.numpy()[passed], np.asarray(jT)[passed], atol=1e-5)
    np.testing.assert_allclose(T.numpy(), np.asarray(jT), atol=1e-4)


@pytest.mark.parametrize("checkers", [(), CHECKERS, (("normal", 0.5),)])
def test_eval_hypotheses_empty_mask_matches_jax(prepared, checkers):
    """An all-false keep mask: JAX's choice with p = 0 everywhere samples
    index 0, and so does the port's own draw. The n coinciding points make
    H rounding noise; the centroids round as XLA's, so the poses follow the
    same noise: T within 1e-5, fitness 0 (or -1 where a checker fails)."""
    prep = prepared
    empty = jnp.zeros_like(prep["corr_mask"])
    kinds = tuple(k for k, _ in checkers)
    values = tuple(v for _, v in checkers)
    key = jax.random.PRNGKey(7)
    j_samples = np.asarray(jax.random.choice(key, prep["src"].num_points, shape=(256, 3),
                                             replace=True, p=empty.astype(jnp.float32)))
    assert not j_samples.any()
    jfit, jrmse, jT = jgr._eval_hypotheses(
        key, prep["src"].points, prep["tgt"].points, prep["src"].normals, prep["tgt"].normals,
        prep["corr_idx"], empty, prep["mc"], 3, 256, kinds, jnp.asarray(values, jnp.float32))
    inputs = port_inputs(prep)[:5] + (torch.zeros_like(port_inputs(prep)[5]),)
    generator = torch.Generator()
    generator.manual_seed(0)
    fit, rmse, T = gr._eval_hypotheses(generator, *inputs, prep["mc"], 3, 256, kinds, values)
    fit0, _, T0 = gr._eval_hypotheses(None, *inputs, prep["mc"], 3, 256, kinds, values,
                                      samples=np.zeros((256, 3), np.int64))
    np.testing.assert_array_equal(fit.numpy(), fit0.numpy())
    np.testing.assert_array_equal(T.numpy(), T0.numpy())
    np.testing.assert_array_equal(fit.numpy(), np.asarray(jfit))
    assert set(np.unique(fit.numpy())) <= {0.0, -1.0}
    np.testing.assert_allclose(rmse.numpy(), np.asarray(jrmse), atol=1e-5)
    np.testing.assert_allclose(T.numpy(), np.asarray(jT), atol=1e-5)


def test_ransac_registration_empty_mask_matches_jax(golden, monkeypatch):
    """`ransac_registration` where the feature matching keeps no pair (as
    `mutual_filter` can leave it): both packages run every batch, report
    fitness 0 and not converged, and return the same T."""
    def empty_mask(real):
        def correspondences(src_f, tgt_f, mutual_filter):
            idx, keep = real(src_f, tgt_f, mutual_filter)
            return idx, keep & False
        return correspondences

    monkeypatch.setattr(jgr, "_feature_correspondences", empty_mask(jgr._feature_correspondences))
    monkeypatch.setattr(gr, "_feature_correspondences", empty_mask(gr._feature_correspondences))
    vox = float(golden["voxel_size"])
    params = P.RANSACRegistrationParams(
        voxel_size=vox, max_correspondence=float(golden["max_correspondence"]),
        mutual_filter=True, checkers=tuple(P.CorrespondenceChecker(k, v) for k, v in CHECKERS),
        max_iteration=1024, confidence=0.999)
    want = jgr.ransac_registration(
        JPointCloud(points=jnp.asarray(golden["source"], jnp.float32)),
        JPointCloud(points=jnp.asarray(golden["target"], jnp.float32)), params, seed=0)
    got = gr.ransac_registration(PointCloud(points=t(golden["source"])),
                                 PointCloud(points=t(golden["target"])), params, seed=0)
    assert got.fitness == want.fitness == 0.0
    assert got.converged is want.converged is False
    assert got.num_iterations == want.num_iterations == 1024
    np.testing.assert_allclose(got.transformation, want.transformation, atol=1e-5)


def test_ransac_search_with_jax_draws_matches_jax(prepared):
    prep = prepared
    kinds = tuple(k for k, _ in CHECKERS)
    values = tuple(v for _, v in CHECKERS)
    batch, max_batches = 128, 40
    jf, jr, jT, jtotal = jgr._ransac_search(
        jax.random.PRNGKey(3), prep["src"].points, prep["tgt"].points, prep["src"].normals,
        prep["tgt"].normals, prep["corr_idx"], prep["corr_mask"],
        jnp.asarray(prep["mc"], jnp.float32), jnp.asarray(0.999, jnp.float32), 3, batch,
        max_batches, kinds, jnp.asarray(values, jnp.float32))
    draws = jax_batches(3, prep["src"].num_points, prep["corr_mask"], batch, 3, max_batches)
    f, r, T, total = gr._ransac_search(None, *port_inputs(prep), prep["mc"], 0.999, 3, batch,
                                       max_batches, kinds, values, samples=draws)
    assert total == int(jtotal) < batch * max_batches     # the confidence exit
    assert float(f) == float(jf) > 0
    np.testing.assert_allclose(float(r), float(jr), atol=1e-5)
    np.testing.assert_allclose(T.numpy(), np.asarray(jT), atol=1e-4)


def test_tuple_test_and_fgr_optimize_match_jax(prepared, golden):
    prep = prepared
    src_c = prep["src"].points
    # Half the correspondences exact under the true pose, half the feature
    # matches: triples of both kinds.
    T_true = np.asarray(golden["T_true"], np.float32)
    exact = np.asarray(src_c) @ T_true[:3, :3].T + T_true[:3, 3]
    half = np.arange(src_c.shape[0]) < src_c.shape[0] // 2
    tgt_c = jnp.asarray(np.where(half[:, None], exact,
                                 np.asarray(prep["tgt"].points[prep["corr_idx"]])))
    key = jax.random.PRNGKey(5)
    jkeep = jgr._tuple_test(key, src_c, tgt_c, jnp.asarray(0.95, jnp.float32), 1000)
    idx = np.asarray(jax.random.randint(key, (1000, 3), 0, src_c.shape[0]))
    keep = gr._tuple_test(None, t(src_c), t(tgt_c), 0.95, 1000, idx=idx)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert 0 < keep.sum() < len(keep)

    mask = (jkeep & prep["corr_mask"]).astype(jnp.float32)
    for decrease in (True, False):
        jT, jfit, jrmse = jgr._fgr_optimize(src_c, tgt_c, mask, jnp.asarray(0.3, jnp.float32),
                                            jnp.asarray(1.4, jnp.float32), 64, decrease)
        T, fit, rmse = gr._fgr_optimize(t(src_c), t(tgt_c), t(mask), 0.3, 1.4, 64, decrease)
        np.testing.assert_allclose(T.numpy(), np.asarray(jT), atol=1e-4)
        np.testing.assert_allclose(float(fit), float(jfit), atol=1e-6)
        np.testing.assert_allclose(float(rmse), float(jrmse), atol=1e-5)


def test_port_ransac_and_fgr_match_golden(golden):
    """RANSAC with the port's own draws (CPU generator, seed 0) and FGR
    under tests/test_goldens.py's asserts: the coarse pose basin and the
    f64 quality oracle. RANSAC's pose does not hang on one draw: the port's
    CPU stream lands in the basin at 11 of seeds 0-11. FGR's tuple test
    draws 1000 triples and keeps the indices of those that pass (the JAX
    package's semantics); on this pair only a handful of correspondences
    survive, so whether FGR lands in the basin depends on the draw in both
    packages. FGR therefore runs on the triples JAX's `randint` draws at
    seed 0, the seed tests/test_goldens.py holds the JAX package to, so the
    result does not hang on the torch generator's stream;
    scripts/torch_global_draws.py reports how the port's own draws fare
    over a range of seeds."""
    src = PointCloud(points=t(golden["source"]))
    tgt = PointCloud(points=t(golden["target"]))
    vox = float(golden["voxel_size"])
    mc = float(golden["max_correspondence"])
    ransac = P.RANSACRegistrationParams(
        voxel_size=vox, max_correspondence=mc, mutual_filter=True,
        checkers=tuple(P.CorrespondenceChecker(k, v if k != "distance" else mc)
                       for k, v in CHECKERS),
        max_iteration=20000, confidence=0.999)
    fgr = P.FGRRegistrationParams(voxel_size=vox)
    m = gr.preprocess_point_cloud(src, vox)[0].num_points
    idx = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (fgr.max_tuple_count, 3), 0, m))
    results = [gr.ransac_registration(src, tgt, ransac, seed=0),
               gr.fgr_registration(src, tgt, fgr, idx=idx)]
    src_d = _voxel_downsample_oracle(golden["source"], vox)
    tgt_d = _voxel_downsample_oracle(golden["target"], vox)
    for res in results:
        ang, trn = _pose_err(res.transformation, golden["T_true"])
        assert ang < 0.15 and trn < 2.5 * vox, (ang, trn)
        fit, rmse = _fitness_rmse_oracle(src_d, tgt_d, res.transformation, mc)
        assert fit >= 0.85, fit
        assert rmse <= 0.8 * vox, rmse
        assert 0.0 < res.fitness <= 1.0
        assert res.transformation.dtype == np.float64
    assert 0 < results[0].num_iterations <= 20000 and results[0].converged
    assert results[1].num_iterations == 64


def test_ransac_recovers_large_transform_and_refines():
    """tests/test_global_registration.py's displaced pair through the port,
    then ICP: within 0.05 of the truth."""
    from gaussiansplattingregistration_tpu_torch.ops import icp

    jsrc, jtgt, T_gt = displaced_pair(np.random.default_rng(42))
    src, tgt = PointCloud(points=t(jsrc.points)), PointCloud(points=t(jtgt.points))
    params = P.RANSACRegistrationParams(
        voxel_size=0.1, mutual_filter=True, max_correspondence=0.15, max_iteration=20000,
        checkers=(P.CorrespondenceChecker("edge_length", 0.9),
                  P.CorrespondenceChecker("distance", 0.15)))
    res = gr.ransac_registration(src, tgt, params, seed=3)
    assert res.fitness > 0.3
    refined = icp.icp(src, tgt, P.LocalRegistrationParams(max_correspondence=0.2,
                                                          max_iteration=50),
                      init_transform=res.transformation)
    ang, trn = _pose_err(refined.transformation, T_gt)
    assert ang + trn < 0.05, (ang, trn)


@pytest.mark.parametrize("method", ["ransac", "fgr"])
def test_cli_global_register_prints_jax_keys(tmp_path, capsys, method):
    src, tgt = os.path.join(DATA, "demo_source.ply"), os.path.join(DATA, "demo_target.ply")
    args = ["register", src, tgt, "--method", method, "--voxel-size", "0.1",
            "--checker-edge-length", "0.9", "--max-correspondence", "0.2",
            "--max-iteration", "2000",
            "--init-transform", "1 0 0 0.01  0 1 0 0  0 0 1 0  0 0 0 1"]
    out = tmp_path / "t.json"
    port_main([*args, "--output", str(out), "--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    parsed = jax_parser().parse_args(args)
    parsed.fn(parsed)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want) == {"transformation", "fitness", "inlier_rmse",
                                     "num_iterations"}
    assert json.loads(out.read_text()) == got
    T = np.asarray(got["transformation"])
    assert T.shape == (4, 4) and np.isfinite(T).all()
    np.testing.assert_allclose(T[:3, :3] @ T[:3, :3].T, np.eye(3), atol=1e-5)
    assert 0.0 <= got["fitness"] <= 1.0
    if method == "fgr":
        assert got["num_iterations"] == want["num_iterations"] == 2000
    else:
        assert 0 < got["num_iterations"] <= 2048 and got["num_iterations"] % 512 == 0
