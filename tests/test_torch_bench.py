"""Torch port: bench_torch.py, the port's benchmark runner, against bench.py.

The truncation oracle against the JAX package's steps (bench.py's
`oracle_gate` on backend "xla"): the same splats, poses and config give the
same longest tile run and K_exact, and each pose's PSNR within 0.05 dB. The
gates raise with bench.py's wording. `main` on the CPU, at small sizes,
keeps bench.py's stdout contract and its metric names and detail keys.
"""

import dataclasses
import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_torch as B
from gaussiansplattingregistration_tpu.models.camera import Camera as JCamera
from gaussiansplattingregistration_tpu.ops import math3d as jmath3d
from gaussiansplattingregistration_tpu.ops.rasterize import RasterizeConfig as JConfig
from gaussiansplattingregistration_tpu.ops.rasterize import rasterize_arrays as j_rasterize
from gaussiansplattingregistration_tpu.ops.rasterize import (
    rasterize_arrays_with_stats as j_rasterize_stats,
)
from port_scenes import two_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_torch_threads")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

SECONDARY_DETAIL = {
    "icp_p2p_iters_per_s_100k_pts": {
        "fitness", "rmse", "iters", "wall_s", "volumetric_grid_iters_per_s",
        "volumetric_fitness"},
    "global_fpfh_ransac_plus_colored_refine_wall_s_50k_pts": {
        "ransac_fitness", "refine_fitness", "ransac_hypotheses", "ransac_hypotheses_per_s"},
    "hem3_plus_multiscale_wall_s_200k_splats": {
        "hem_s", "hem_cold_s", "multiscale_s", "level_sizes", "hem_stats", "fitness"},
    "photometric_pose_opt_steps_per_s_100k_splats_640x360": {"final_loss", "launches"},
}
STATS = {"coverage_clipped_splats", "overflow_tiles", "dropped_entries", "total_entries",
         "max_run", "bwd_cap_violations", "max_live", "mean_live", "max_count",
         "live_tile_overflow"}
TRUNCATION = {"truncation_psnr_db", "truncation_psnr_per_view_db",
              "truncation_psnr_clustered_db", "truncation_psnr_clustered_per_view_db",
              "clustered_k_exact"}


def small_headline(monkeypatch):
    """The headline at a small size: a 480x48 strip keeps bench.py's focal
    length for a 480-pixel width, at which the nearest splats of the
    uniform scene pass the 3-pixel radius cull; 20k splats, one warm-up
    frame and two timed frames."""
    for name, value in (("N_SPLATS", 20_000), ("WIDTH", 480), ("HEIGHT", 48),
                        ("WARMUP", 1), ("ITERS", 2)):
        monkeypatch.setattr(B, name, value)


def jax_oracle(arrays, viewmats, intr, width, height, config):
    """bench.py's `oracle_gate` steps through the JAX package, every render
    on backend "xla": (per-view PSNR, K_exact, max_run)."""
    args = [jnp.asarray(a.numpy()) for a in arrays]
    bg = jnp.zeros(3, jnp.float32)
    probe = dataclasses.replace(config, max_tiles_per_splat=8, tile_chunk=4)
    max_run = max(int(j_rasterize_stats(*args, vm, intr, width, height, 0, bg, probe)[3]
                      ["max_run"]) for vm in viewmats)
    k_exact = -(-max_run // 128) * 128
    oracle = dataclasses.replace(config, max_tiles_per_splat=8, max_splats_per_tile=k_exact,
                                 tile_chunk=4, max_bwd_splats_per_tile=None)
    per_view = []
    for vm in viewmats:
        rgb_t = j_rasterize(*args, vm, intr, width, height, 0, bg, config)[0]
        rgb_e = j_rasterize(*args, vm, intr, width, height, 0, bg, oracle)[0]
        mse = float(jnp.mean((rgb_t - rgb_e) ** 2))
        per_view.append(10.0 * math.log10(1.0 / max(mse, 1e-12)))
    return per_view, k_exact, max_run


@pytest.mark.parametrize("scene", ["uniform", "clustered"])
def test_truncation_oracle_matches_jax(scene):
    """4000 splats of bench.py's draws seen by a 160x96 crop of the bench
    camera (its 1280-pixel focal length, so splats keep their pixel sizes)
    at the three oracle poses; K = 8 truncates visibly (PSNR 20-45 dB).
    The port renders the truncated frame on backend "cuda" (its twin on the
    CPU) and the oracle on "torch"; the JAX side both on "xla". max_run and
    K_exact equal; each PSNR within 0.05 dB."""
    draws = B.uniform_draws if scene == "uniform" else B.clustered_draws
    arrays = B.splat_arrays(draws(4000), CPU)
    xyz, scales, quats, _, _ = draws(4000)
    np.testing.assert_allclose(
        arrays[1].numpy(),
        np.asarray(jmath3d.covariance_from_scaling_rotation(jnp.asarray(scales),
                                                            jnp.asarray(quats))),
        rtol=1e-5, atol=1e-9)
    f = 1280 / (2 * math.tan(math.radians(70) / 2))
    width, height = 160, 96
    cams = []
    for yaw in B.ORACLE_YAWS:
        R = np.asarray(jmath3d.axis_angle_to_rotmat(jnp.asarray([0.0, 1.0, 0.0]),
                                                    jnp.asarray(yaw)))
        cams.append(JCamera.create(R, [0.0, 0.0, 3.0], f, f, width, height))
    viewmats = [np.array(c.viewmat) for c in cams]
    intr = np.array(cams[0].intrinsics)
    # The port's own poses are these (its viewmat does not depend on f).
    for got, want in zip(B.orbit_viewmats(CPU), viewmats):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)

    kw = dict(max_tiles_per_splat=4, max_splats_per_tile=8, tile_chunk=32)
    got = B.truncation_oracle(arrays, [torch.as_tensor(v) for v in viewmats],
                              torch.as_tensor(intr), width, height,
                              B.RasterizeConfig(backend="cuda", **kw), scene)
    want = jax_oracle(arrays, viewmats, intr, width, height, JConfig(backend="xla", **kw))
    assert got[1:] == want[1:]
    assert all(20.0 <= p <= 45.0 for p in want[0]), want[0]
    np.testing.assert_allclose(got[0], want[0], atol=0.05)


@pytest.mark.parametrize("change, message", [
    (dict(max_bwd_splats_per_tile=1), r"drops gradients \(\d+ tiles over the bwd cap\)"),
    (dict(max_live_tiles=8), r"drops \d+ live tiles \(max_live_tiles too small"),
    (dict(max_splats_per_tile=8), r"truncation is visible: min \d+\.\d dB < 40 dB vs the "
                                  r"C=8/K=128 exact render over 3 poses"),
], ids=["bwd_cap", "max_live_tiles", "truncation"])
def test_headline_gates_raise(monkeypatch, change, message):
    """Each of the headline's gates refuses a config that drops work: a
    backward cap below the tiles' horizon, a row cap below the live tiles,
    a K whose render is under 40 dB against the oracle."""
    small_headline(monkeypatch)
    config = dataclasses.replace(B.headline_config(), **change)
    monkeypatch.setattr(B, "headline_config", lambda: config)
    with pytest.raises(RuntimeError, match=message):
        B.bench_raster(CPU)


def test_hem_gate_raises_on_a_sparse_scene(monkeypatch):
    """At 6000 splats config 3's scene is too sparse to cut each level by
    1.8x: bench.py's gate refuses it, after printing the level sizes."""
    monkeypatch.setattr(B, "HEM_SPLATS", 6000)
    with pytest.raises(RuntimeError, match="HEM bench scene is not clustering: sizes"):
        B.bench_hem_multiscale(CPU)


def test_main_keeps_the_stdout_contract(monkeypatch, capsys, tmp_path):
    """`main` on the CPU at small sizes: stdout is one line, the headline
    JSON with bench.py's keys, its detail the stats, the truncation keys,
    `card` and `launches` (0 on the CPU: the twins ran). `--extra-out`
    holds the four secondaries by bench.py's names and detail keys, none
    failed. Nothing else is written into the tree. Config 3 runs at 46k
    splats: below ~44k its scene fails the 1.8x gate (see the test
    above)."""
    small_headline(monkeypatch)
    for name, value in (("ICP_POINTS", 2000), ("GLOBAL_POINTS", 3000), ("HEM_SPLATS", 46_000),
                        ("PHOTO_SPLATS", 2000), ("PHOTO_WIDTH", 160), ("PHOTO_HEIGHT", 96)):
        monkeypatch.setattr(B, name, value)
    before = sorted(os.listdir(REPO))
    extra = tmp_path / "extra.json"
    B.main(["--device", "cpu", "--extra-out", str(extra)])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    head = json.loads(lines[-1])
    assert set(head) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert head["metric"] == "rasterize_fwd_bwd_pixels_per_s_per_chip_1M_splats"
    assert head["unit"] == "pixels/s/chip" and head["value"] > 0
    assert head["vs_baseline"] == round(head["value"] / B.H100_FWD_BWD_PIXELS_PER_S, 4)
    detail = head["detail"]
    assert set(detail) == STATS | TRUNCATION | {"card", "launches"}
    assert detail["card"] == "cpu"
    assert detail["launches"] == {"composite_fwd": 0, "composite_bwd": 0, "tile_bin": 0}
    assert detail["truncation_psnr_db"] >= 40.0
    assert len(detail["truncation_psnr_per_view_db"]) == 3
    assert detail["bwd_cap_violations"] == 0 and detail["live_tile_overflow"] == 0

    saved = json.loads(extra.read_text())
    assert saved["headline"] == head
    secondary = {r["metric"]: r for r in saved["secondary"]}
    assert set(secondary) == set(SECONDARY_DETAIL)
    for metric, keys in SECONDARY_DETAIL.items():
        rec = secondary[metric]
        assert "error" not in rec, rec
        assert set(rec) == {"metric", "value", "unit", "vs_baseline", "detail"}
        assert set(rec["detail"]) == keys and rec["vs_baseline"] is None
    assert secondary["icp_p2p_iters_per_s_100k_pts"]["detail"]["iters"] == 30
    assert secondary["hem3_plus_multiscale_wall_s_200k_splats"]["unit"] == "s"
    assert sorted(os.listdir(REPO)) == before


def test_a_failing_secondary_is_reported_not_raised(monkeypatch, capsys, tmp_path):
    """bench.py's catch: a secondary that raises becomes an entry with its
    name and `error`, and the headline is still the one stdout line. With
    `--headline-only` no secondary runs; without a card and without
    `--device cpu`, `main` raises before any work."""
    small_headline(monkeypatch)
    names = ["bench_icp", "bench_global", "bench_hem_multiscale", "bench_photometric"]

    def broken(name):
        def bench(dev):
            raise ValueError("no such cloud")
        bench.__name__ = name
        return bench

    for name in names:
        monkeypatch.setattr(B, name, broken(name))
    extra = tmp_path / "extra.json"
    B.main(["--device", "cpu", "--extra-out", str(extra)])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0])["metric"] == "rasterize_fwd_bwd_pixels_per_s_per_chip_1M_splats"
    secondary = json.loads(extra.read_text())["secondary"]
    assert [r["metric"] for r in secondary] == names
    assert all(r["error"] == "ValueError('no such cloud')" for r in secondary)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        B.main(["--headline-only"])
    for name, value in (("N_SPLATS", 2000), ("ITERS", 1)):
        monkeypatch.setattr(B, name, value)
    B.main(["--headline-only", "--device", "cpu", "--extra-out", str(extra)])
    assert json.loads(extra.read_text())["secondary"] == []
