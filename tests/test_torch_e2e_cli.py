"""The port's CLI end to end on the committed demo pair, on the CPU.

tests/test_e2e_cli.py's flow through the port's CLI with `--device cpu`:
register (ICP) -> multiscale --use-mixture (HEM) -> photometric refine ->
evaluate (LPIPS) -> merge -> render, at its thresholds (every pose error
< 2e-2, PSNR > 28, lpips not null, num_points == 2n). The GT PNGs are the
port's render of the pair merged under its true transform, written by
`utils/png.py`. The photometric step runs 20 Adam steps where the JAX
test runs 80: it starts from the multiscale pose, already inside the
threshold, and chip_smoke.py's `cli_e2e` phase runs the 80 on the card.
`register` and `merge` are also held against the JAX CLI's outputs,
misused options must raise, and no option is left unported.
"""

import json
import os

import numpy as np
import pytest

from gaussiansplattingregistration_tpu.cli.main import _save_transform as jax_save
from gaussiansplattingregistration_tpu.cli.main import build_parser as jax_parser
from gaussiansplattingregistration_tpu_torch.cli.main import main as port_main
from port_scenes import (  # noqa: F401
    check_png,
    demo_photometric_views,
    pose_error,
    two_torch_threads,
)

pytestmark = pytest.mark.usefixtures("two_torch_threads")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
SRC = os.path.join(DATA, "demo_source.ply")
TGT = os.path.join(DATA, "demo_target.ply")


@pytest.fixture(scope="module")
def truth():
    with open(os.path.join(DATA, "demo_transform.json")) as f:
        return json.load(f)


def port_cli(capsys, *args):
    """The port's CLI in this process on the CPU; its last line as JSON."""
    port_main([*map(str, args), "--device", "cpu"])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def jax_cli(capsys, *args):
    """The JAX CLI's subcommand in this process (on the CPU, as conftest
    sets JAX up); its last line as JSON."""
    parsed = jax_parser().parse_args([*map(str, args)])
    parsed.fn(parsed)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def transform_keys(capsys, extra):
    jax_save(np.eye(4), None, extra)
    return set(json.loads(capsys.readouterr().out))


def test_full_cli_flow(tmp_path, capsys, truth):
    T_off = np.asarray(truth["T_offset"])
    t1, t2, t3 = (tmp_path / f"t{i}.json" for i in (1, 2, 3))

    out = port_cli(capsys, "register", SRC, TGT, "--method", "point_to_point",
                   "--max-correspondence", "0.3", "--max-iteration", "30", "--output", t1)
    assert set(out) == transform_keys(capsys, {"fitness": 0, "inlier_rmse": 0,
                                               "num_iterations": 0})
    assert pose_error(json.loads(t1.read_text())["transformation"], T_off) < 2e-2

    out = port_cli(capsys, "multiscale", SRC, TGT, "--use-mixture", "--voxel-values", "0.3,0.1",
                   "--iter-values", "15,10", "--init-transform", t1, "--output", t2)
    assert set(out) == transform_keys(capsys, {"fitness": 0, "inlier_rmse": 0})
    assert pose_error(json.loads(t2.read_text())["transformation"], T_off) < 2e-2

    img_dir = tmp_path / "images"
    img_dir.mkdir()
    cams_json, _, _ = demo_photometric_views(str(img_dir), 64, "cpu")
    port_cli(capsys, "photometric", SRC, "--second", TGT, "--cameras", cams_json,
             "--images-path", img_dir, "--init-transform", t2, "--steps", "20", "--lr", "1e-3",
             "--output", t3)
    assert pose_error(json.loads(t3.read_text())["transformation"], T_off) < 2e-2

    log = tmp_path / "eval.json"
    metrics = port_cli(capsys, "evaluate", SRC, TGT, "--transform", t3, "--cameras", cams_json,
                       "--images-path", img_dir, "--log", log, "--sharded", "off")
    assert metrics["psnr"] > 28.0, metrics
    assert metrics["lpips"] is not None and metrics["lpips_weights"] == "random"
    assert json.loads(log.read_text())["psnr"] == metrics["psnr"]
    assert set(metrics) == {"registration_data", "mse", "rmse", "ssim", "psnr", "lpips",
                            "lpips_weights", "error_list"}
    auto = port_cli(capsys, "evaluate", SRC, TGT, "--transform", t3, "--cameras", cams_json,
                    "--images-path", img_dir, "--no-lpips")
    assert auto["lpips"] is None and auto["psnr"] == metrics["psnr"]

    merged = tmp_path / "merged.ply"
    out = port_cli(capsys, "merge", SRC, TGT, merged, "--transform", t3)
    assert out == {"output": str(merged), "num_points": 2 * truth["n"]}
    png = tmp_path / "render.png"
    port_cli(capsys, "render", merged, png, "--width", "96", "--height", "96")
    check_png(str(png), 96, 96)


def test_register_and_merge_match_jax_cli(tmp_path, capsys):
    args = ["register", SRC, TGT, "--method", "point_to_point", "--max-correspondence", "0.3",
            "--max-iteration", "30"]
    got = port_cli(capsys, *args)
    want = jax_cli(capsys, *args)
    assert set(got) == set(want)
    np.testing.assert_allclose(got["transformation"], want["transformation"], atol=1e-5)
    assert got["num_iterations"] == want["num_iterations"]
    assert abs(got["fitness"] - want["fitness"]) <= 1e-6
    T = tmp_path / "t.json"
    T.write_text(json.dumps({"transformation": got["transformation"]}))
    got = port_cli(capsys, "merge", SRC, TGT, tmp_path / "p.ply", "--transform", T)
    want = jax_cli(capsys, "merge", SRC, TGT, tmp_path / "j.ply", "--transform", T)
    assert got["num_points"] == want["num_points"]
    assert set(got) == set(want)


def test_downsample_prints_jax_keys(tmp_path, capsys):
    out = port_cli(capsys, "downsample", SRC, tmp_path / "ds", "--cluster-level", "2")
    assert set(out) == {"input_points", "levels"} and len(out["levels"]) == 2
    sizes = [out["input_points"]] + [lvl["points"] for lvl in out["levels"]]
    assert sizes == sorted(sizes, reverse=True) and sizes[-1] < sizes[0]
    for i, lvl in enumerate(out["levels"], start=1):
        assert set(lvl) == {"level", "points", "path"} and lvl["level"] == i
        assert os.path.exists(lvl["path"])


@pytest.mark.parametrize("args", [
    pytest.param(["--method", "ransac", "--plane-inliers-first", "p.json"],
                 id="first_only-ransac"),
    pytest.param(["--method", "fgr", "--plane-inliers-second", "q.json"],
                 id="second_only-fgr"),
    pytest.param(["--plane-inliers-first", "p.json"], id="first_only-point_to_point"),
])
def test_plane_inlier_flags_must_pair(args):
    with pytest.raises(SystemExit, match="given together"):
        port_main(["register", SRC, TGT, *args, "--device", "cpu"])


def test_unported_options_raise():
    """`evaluate --sharded on` is ported: it no longer exits as unported but
    makes its process group, reaches the cameras file (missing here) and
    ends the group it made."""
    import torch.distributed as dist

    with pytest.raises(FileNotFoundError, match="c.json"):
        port_main(["evaluate", SRC, TGT, "--cameras", "c.json", "--images-path", ".",
                   "--sharded", "on", "--device", "cpu"])
    assert not dist.is_initialized()
