"""Torch port vs JAX package: the viewer server, camera controls, and the
logging, checkpoint and profiling utilities.

The viewer's four endpoint tests of tests/test_viewer.py run against the
port's server (backend "torch", CPU, 128x96); one 64x48 query (both
viewers clamp it to 64x64) matches the JAX viewer's PNG within one 8-bit
level (the render tests' 1e-5 on the image). The camera helpers and orbit
controls match JAX's within 1e-6.
Checkpoints written by either package load in the other (transformation,
twist, loss history and mixture levels equal).
"""

import json
import os
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiansplattingregistration_tpu.models import camera as jcamera
from gaussiansplattingregistration_tpu.ops import hem as jhem
from gaussiansplattingregistration_tpu.ops.rasterize import RasterizeConfig as JRasterizeConfig
from gaussiansplattingregistration_tpu.pipelines import viewer as jviewer
from gaussiansplattingregistration_tpu.utils import checkpoint as jcheckpoint
from gaussiansplattingregistration_tpu_torch.models import camera
from gaussiansplattingregistration_tpu_torch.models.gaussian_cloud import GaussianCloud
from gaussiansplattingregistration_tpu_torch.ops import hem
from gaussiansplattingregistration_tpu_torch.ops.rasterize import RasterizeConfig
from gaussiansplattingregistration_tpu_torch.pipelines import viewer
from gaussiansplattingregistration_tpu_torch.utils import checkpoint, profiling
from gaussiansplattingregistration_tpu_torch.utils.logging import (
    CancelledError,
    ProgressReporter,
    RunLogger,
)
from gaussiansplattingregistration_tpu_torch.utils.png import decode_png, encode_png
from tests.conftest import make_random_cloud
from port_scenes import two_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_torch_threads")


def port_cloud(jcloud):
    return GaussianCloud.from_numpy_dict(jcloud.to_numpy_dict(), device="cpu")


@pytest.fixture(scope="module")
def jcloud():
    rng = np.random.default_rng(5)
    return make_random_cloud(rng, n=200, sh_degree=1, scale_range=(0.05, 0.15))


@pytest.fixture(scope="module")
def server(jcloud):
    cfg = RasterizeConfig(max_splats_per_tile=64, tile_chunk=4, backend="torch")
    srv, _ = viewer.serve(port_cloud(jcloud), port=0, width=128, height=96, config=cfg,
                          device="cpu")
    try:
        yield srv
    finally:
        srv.shutdown()
        srv.server_close()


def _get(server, path):
    host, port = server.server_address[:2]
    with urllib.request.urlopen(f"http://{host}:{port}{path}", timeout=120) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def test_viewer_page(server):
    code, ctype, body = _get(server, "/")
    assert code == 200 and ctype.startswith("text/html")
    assert b"/render?" in body


def test_viewer_state(server):
    code, _, body = _get(server, "/state")
    assert code == 200
    st = json.loads(body)
    assert st["num_points"] == 200 and st["sh_degree"] == 1
    assert st["aabb_min"][0] < st["aabb_max"][0]


def test_viewer_render_default_and_orbit(server):
    code, ctype, body = _get(server, "/render?w=128&h=96")
    assert code == 200 and ctype == "image/png"
    img0 = decode_png(body)
    assert img0.shape == (96, 128, 3)
    assert img0.std() > 1.0
    code, _, body2 = _get(server, "/render?w=128&h=96&yaw=0.5&pitch=0.2&zoom=-3&panx=40&pany=-20")
    img1 = decode_png(body2)
    assert code == 200 and img1.shape == (96, 128, 3)
    assert np.abs(img1.astype(int) - img0.astype(int)).mean() > 0.5
    # Sizes are clamped to 64..1920 x 64..1440.
    assert decode_png(_get(server, "/render?w=10&h=5000")[2]).shape == (1440, 64, 3)


def test_viewer_render_bad_params(server):
    with pytest.raises(urllib.error.HTTPError) as exc:
        _get(server, "/render?w=nan&h=96")
    assert exc.value.code == 500
    code, _, _ = _get(server, "/render?w=128&h=96")
    assert code == 200
    with pytest.raises(urllib.error.HTTPError) as exc:
        _get(server, "/nowhere")
    assert exc.value.code == 404


def test_viewer_frame_matches_jax(jcloud):
    """The same 64x48 query rendered by both viewers (torch and xla
    backends), the height clamped to 64 by both: the same PNG within one
    8-bit level."""
    from PIL import Image
    import io

    q = {"w": "64", "h": "48", "yaw": "0.3", "pitch": "-0.2", "roll": "0.5", "panx": "7",
         "pany": "-14", "zoom": "-2"}
    jscene = jviewer.ViewerScene(jcloud, config=JRasterizeConfig(max_splats_per_tile=64,
                                                                 tile_chunk=4, backend="xla"))
    scene = viewer.ViewerScene(port_cloud(jcloud), device="cpu",
                               config=RasterizeConfig(max_splats_per_tile=64, tile_chunk=4,
                                                      backend="torch"))
    want = np.asarray(Image.open(io.BytesIO(jscene.render_png(q))))
    got = decode_png(scene.render_png(q))
    assert got.shape == want.shape == (64, 64, 3)
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1
    assert got.std() > 1.0
    assert scene.state_json() == jscene.state_json()


def test_png_encoder_roundtrip(rng):
    for shape in ((5, 7), (9, 6, 3)):
        img = rng.integers(0, 256, size=shape, dtype=np.uint8)
        np.testing.assert_array_equal(decode_png(encode_png(img)), img)


# --------------------------------------------------------------- cameras

def make_cams():
    args = (np.eye(3), [0.0, 0.0, 4.0], 100.0, 100.0, 200, 150)
    return jcamera.Camera.create(*args), camera.Camera.create(*args, device="cpu")


def assert_cams_close(c, jc):
    np.testing.assert_allclose(c.rotation.numpy(), np.asarray(jc.rotation), atol=1e-6)
    np.testing.assert_allclose(c.position.numpy(), np.asarray(jc.position), atol=1e-6)
    np.testing.assert_allclose(float(c.fx), float(jc.fx), atol=1e-6)
    assert (c.width, c.height) == (jc.width, jc.height)


@pytest.mark.parametrize("control, args", [
    ("rotate", (0.2, -0.1)), ("translate", (100.0, -30.0)), ("roll", (10.0,)),
    ("zoom", (1.0, [-1, -1, -1], [1, 1, 1])), ("zoom", (-3.0, [-0.2, 0, 0], [0.1, 0.3, 0.2])),
    ("resized", (0.5,)),
])
def test_camera_controls_match_jax(control, args):
    jc, c = make_cams()
    jc, c = jc.rotate(0.4, 0.1), c.rotate(0.4, 0.1)
    moved, jmoved = getattr(c, control)(*args), getattr(jc, control)(*args)
    assert_cams_close(moved, jmoved)
    R = moved.rotation.numpy()
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
    np.testing.assert_allclose(moved.viewmat.numpy(), np.asarray(jmoved.viewmat), atol=1e-6)


def test_camera_resized_and_focal_helpers():
    _, c = make_cams()
    half = c.resized(0.5)
    assert half.width == 100 and half.height == 75 and abs(float(half.fx) - 50.0) < 1e-6
    assert abs(camera.focal2fov(camera.fov2focal(1.0472, 640), 640) - 1.0472) < 1e-9
    for w, h, value, kind in ((640, 480, 60.0, 1), (640, 480, 0.9, 1), (640, 480, 500.0, 2),
                              (800, 600, 0.0, 0)):
        np.testing.assert_allclose(camera.focal_lengths_from_spec(w, h, value, kind),
                                   jcamera.focal_lengths_from_spec(w, h, value, kind),
                                   atol=1e-6)
    assert camera.fov_x2fov_y(1.2, 16 / 9) == jcamera.fov_x2fov_y(1.2, 16 / 9)
    with pytest.raises(ValueError):
        camera.focal_lengths_from_spec(640, 480, 1.0, 3)


# ------------------------------------------------------- logging, timing

def test_run_logger_and_progress(tmp_path):
    path = str(tmp_path / "run.jsonl")
    rl = RunLogger(path)
    rl.metrics(step=1, fitness=0.9, rmse=0.01)
    with rl.phase("icp", scale=0.05):
        pass
    with pytest.raises(KeyError):
        with rl.phase("bad"):
            raise KeyError("x")
    rl.close()
    lines = [json.loads(line) for line in open(path)]
    assert lines[0]["event"] == "metrics" and lines[0]["fitness"] == 0.9
    assert lines[1]["event"] == "phase_start" and lines[1]["scale"] == 0.05
    assert lines[2]["event"] == "phase_end" and lines[2]["seconds"] >= 0
    assert lines[2]["error"] is None and "KeyError" in lines[4]["error"]

    seen = []
    pr = ProgressReporter(seen.append)
    pr.report(50)
    assert seen == [50] and pr.percent == 50
    pr.checkpoint()
    pr.cancel()
    assert pr.cancelled
    with pytest.raises(CancelledError):
        pr.checkpoint()


def test_stopwatch_timed_and_trace(tmp_path):
    """`trace(log_dir)`, the port's one timing entry point, writes a Chrome
    trace that holds the program's spans."""
    from gaussiansplattingregistration_tpu_torch.ops import knn

    with profiling.trace(str(tmp_path / "trace")):
        knn.nearest_neighbor(torch.rand(8, 3), torch.rand(9, 3))
    files = [f for f in os.listdir(tmp_path / "trace") if f.endswith(".json")]
    assert len(files) == 1
    with open(tmp_path / "trace" / files[0]) as fh:
        names = {ev.get("name") for ev in json.load(fh)["traceEvents"]}
    assert "knn.nearest" in names
    with profiling.trace(None):
        pass


# ------------------------------------------------------------- checkpoint

def levels(rng, module):
    return [module.MixtureLevel(
        xyz=rng.normal(size=(5, 3)).astype(np.float32),
        colors=rng.normal(size=(5, 3)).astype(np.float32),
        opacities=rng.uniform(0, 1, 5).astype(np.float32),
        covariance=rng.normal(size=(5, 6)).astype(np.float32),
        features=rng.normal(size=(5, 9)).astype(np.float32)) for _ in range(2)]


def test_checkpoint_roundtrip(tmp_path, rng):
    path = str(tmp_path / "ckpt")
    T = torch.eye(4, dtype=torch.float64)
    T[0, 3] = 0.5
    twist = torch.tensor(rng.normal(size=6), dtype=torch.float32)
    opt_state = {"state": {0: {"step": torch.tensor(3.0), "exp_avg": torch.ones(6),
                               "exp_avg_sq": torch.full((6,), 2.0)}},
                 "param_groups": [{"lr": 1e-3, "betas": (0.9, 0.999)}]}
    lvls = levels(rng, hem)
    checkpoint.save_checkpoint(path, T, twist=twist, opt_state=opt_state,
                               loss_history=[1.0, 0.5], mixture_levels=lvls,
                               metadata={"note": "unit"})
    template = {"state": {0: {"step": torch.tensor(0.0), "exp_avg": torch.zeros(6),
                              "exp_avg_sq": torch.zeros(6)}},
                "param_groups": [{"lr": 0.0, "betas": (0.0, 0.0)}]}
    got = checkpoint.load_checkpoint(path, opt_state_template=template)
    np.testing.assert_allclose(got["transformation"], T.numpy())
    np.testing.assert_allclose(got["twist"], twist.numpy())
    assert got["loss_history"] == [1.0, 0.5] and got["metadata"] == {"note": "unit"}
    assert isinstance(got["mixture_levels"][1], hem.MixtureLevel)
    np.testing.assert_array_equal(got["mixture_levels"][1].features, lvls[1].features)
    restored = got["opt_state"]
    assert torch.equal(restored["state"][0]["exp_avg_sq"], torch.full((6,), 2.0))
    assert restored["state"][0]["step"].dtype == torch.float32
    assert restored["param_groups"][0]["betas"] == (0.9, 0.999)
    assert float(restored["param_groups"][0]["lr"]) == 1e-3


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_loads_across_packages(tmp_path, rng, writer):
    path = str(tmp_path / "ckpt")
    T = np.eye(4)
    T[:3, 3] = (0.1, -0.2, 0.3)
    twist = rng.normal(size=6)
    save, load, module = ((jcheckpoint.save_checkpoint, checkpoint.load_checkpoint, jhem)
                          if writer == "jax" else
                          (checkpoint.save_checkpoint, jcheckpoint.load_checkpoint, hem))
    lvls = levels(rng, module)
    save(path, T, twist=twist, opt_state=[jnp.zeros(2)] if writer == "jax" else [np.zeros(2)],
         loss_history=[3.0, 2.0, 1.5], mixture_levels=lvls)
    got = load(path)
    np.testing.assert_array_equal(got["transformation"], T)
    np.testing.assert_array_equal(got["twist"], twist)
    assert got["loss_history"] == [3.0, 2.0, 1.5]
    assert len(got["mixture_levels"]) == 2
    for a, b in zip(got["mixture_levels"], lvls):
        for name in ("xyz", "colors", "opacities", "covariance", "features"):
            np.testing.assert_array_equal(np.asarray(getattr(a, name)), getattr(b, name))
