"""Torch port: process groups, the two-process train step
(tests/test_distributed.py's counterpart), the world of one a
single-process caller gets, and `evaluate --sharded` through the CLI
against `--sharded off` and against the JAX package's sharded evaluation.
"""

import json
import math
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from gaussiansplattingregistration_tpu.models.camera import Camera as JCamera
from gaussiansplattingregistration_tpu.models.gaussian_cloud import GaussianCloud as JCloud
from gaussiansplattingregistration_tpu.pipelines import evaluation as j_evaluation
from gaussiansplattingregistration_tpu.utils import io as j_io
from gaussiansplattingregistration_tpu_torch.cli.main import main as port_main
from gaussiansplattingregistration_tpu_torch.parallel import collectives, distributed
from gaussiansplattingregistration_tpu_torch.parallel.mesh import axis_size
from tests.torch_dist_workers import camera_case, cloud_case, run_group, single_device_step
from port_scenes import demo_photometric_views, two_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_torch_threads")

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def multihost_scene():
    """tests/test_distributed.py's scene: 32 splats from rng 0, SH 1."""
    rng = np.random.default_rng(0)
    n = 32
    cloud = JCloud.create(
        xyz=rng.uniform(-1, 1, size=(n, 3)).astype(np.float32),
        features_dc=(rng.normal(size=(n, 1, 3)) * 0.3).astype(np.float32),
        features_rest=np.zeros((n, 3, 3), np.float32),
        opacity=np.full((n, 1), 1.0, np.float32),
        scaling=np.log(rng.uniform(0.05, 0.15, size=(n, 3))).astype(np.float32),
        rotation=rng.normal(size=(n, 4)).astype(np.float32),
        sh_degree=1,
    )
    return cloud, rng.uniform(0, 1, size=(2, 32, 32, 3)).astype(np.float32)


def test_two_process_distributed_train_step(tmp_path):
    """Two processes join one group through `initialize` (torchrun's RANK
    and WORLD_SIZE, a file rendezvous), build meshes over both, run one
    summed sharded computation and one sharded train step over the data
    axis; only rank 0 is primary. The step's loss and gradient are the
    single-process ones."""
    cloud, targets = multihost_scene()
    f = 32 / (2 * math.tan(math.radians(60) / 2))
    cam = camera_case(JCamera.create(np.eye(3), [0.0, 0.0, 4.0], f, f, 32, 32))
    config = dict(max_tiles_per_splat=4, max_splats_per_tile=16, tile_chunk=1)
    cases = {
        "psum": {"kind": "psum", "mesh": (1, 2)},
        "mesh": {"kind": "mesh", "mesh": (1, 2)},
        "step": {"kind": "train_step", "mesh": (2, 1), "cloud": cloud_case(cloud),
                 "cameras": [cam, cam], "targets": targets, "config": config,
                 "compositor": "all_gather", "capacity_slack": 1.5, "xi0": None, "steps": 1},
    }
    got = run_group(2, cases, str(tmp_path))
    assert got["_primary"] is True
    assert got["psum"]["total"] == 28.0
    assert got["mesh"]["world"] == 2 and got["mesh"]["splat"]["size"] == 2
    loss, grad = single_device_step(cases["step"]["cloud"], [cam, cam], targets, np.zeros(6),
                                    config)
    step = got["step"]
    assert np.isfinite(step["loss"][0]) and np.all(np.isfinite(step["xi"][0]))
    assert abs(step["loss"][0] - loss) < 1e-5 * max(loss, 1.0)
    np.testing.assert_allclose(step["grad"][0], grad, rtol=1e-3, atol=1e-5)


@pytest.fixture
def no_torchrun_env(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    yield
    distributed.shutdown()


def test_initialize_builds_a_world_of_one(no_torchrun_env, monkeypatch):
    """Without torchrun's environment `initialize` builds a world of one on
    an in-process store (gloo for the CPU), once: a second call is a no-op.
    The mesh and the collectives then run as on many ranks; `shutdown` ends
    the group. Without a card the default device raises, as every entry
    point's does."""
    assert distributed.initialize(device="cpu") is True
    assert distributed.initialize(device="cpu") is False
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    assert distributed.is_primary() and distributed.world_size() == 1
    mesh = distributed.global_mesh(data=1)
    assert (axis_size(mesh, "data"), axis_size(mesh, "splat")) == (1, 1)
    x = torch.arange(6.0).reshape(3, 2).requires_grad_(True)
    y = collectives.all_gather(x, mesh.get_group("splat"))
    y.sum().backward()
    assert torch.equal(y, x) and torch.equal(x.grad, torch.ones(3, 2))
    assert float(collectives.all_reduce(torch.tensor(2.5), "max")) == 2.5
    distributed.shutdown()
    assert not dist.is_initialized() and distributed.is_primary()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distributed.initialize()
    assert not dist.is_initialized()


def test_cli_evaluate_sharded_matches_off_and_jax(no_torchrun_env, tmp_path, capsys):
    """`evaluate --sharded on` (a world of one on the CPU) against `--sharded
    off` and against the JAX package's `evaluate_registration_sharded` on the
    demo pair's three views: MSE, RMSE, PSNR and SSIM within 1e-5, LPIPS
    null; the CLI ends the group it made."""
    cams_json, init_json, _ = demo_photometric_views(str(tmp_path), 64, "cpu")
    src, tgt = os.path.join(DATA, "demo_source.ply"), os.path.join(DATA, "demo_target.ply")
    common = ["evaluate", src, tgt, "--transform", init_json, "--cameras", cams_json,
              "--images-path", str(tmp_path), "--no-lpips", "--device", "cpu"]
    out = {}
    for mode in ("on", "off"):
        port_main(common + ["--sharded", mode, "--log", str(tmp_path / f"{mode}.json")])
        out[mode] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert json.loads((tmp_path / f"{mode}.json").read_text()) == out[mode]
        assert not dist.is_initialized()
    with open(init_json) as fh:
        T = np.asarray(json.load(fh)["transformation"], np.float32)
    want = j_evaluation.evaluate_registration_sharded(
        j_io.load_gaussian_cloud(src), j_io.load_gaussian_cloud(tgt), jnp.asarray(T),
        j_evaluation.load_cameras_json(cams_json), str(tmp_path))
    assert out["on"]["lpips"] is None and out["on"]["error_list"] == []
    assert set(out["on"]) == set(want.as_log_dict())
    for key in ("mse", "rmse", "psnr", "ssim"):
        assert abs(out["on"][key] - out["off"][key]) < 1e-5, key
        assert abs(out["on"][key] - getattr(want, key)) < 1e-5, key
    assert 0.0 < out["on"]["mse"] < 0.1 and out["on"]["psnr"] > 10.0


def test_library_sharded_evaluation_ends_only_the_group_it_made(no_torchrun_env, tmp_path):
    """`evaluate_registration_sharded` without a mesh makes a world of one
    and ends it; under its caller's group it leaves that group up. A missing
    image and one whose size differs from its camera's land in `error_list`
    as in `evaluate_registration`, and the metrics of the usable views agree
    within 1e-5."""
    import dataclasses

    from gaussiansplattingregistration_tpu_torch.pipelines import evaluation
    from gaussiansplattingregistration_tpu_torch.utils import io

    cams_json, init_json, _ = demo_photometric_views(str(tmp_path), 64, "cpu")
    cams = evaluation.load_cameras_json(cams_json, device="cpu")
    cams = [cams[0], dataclasses.replace(cams[1], image_name="absent"), cams[2].resized(0.5)]
    with open(init_json) as fh:
        T = torch.as_tensor(json.load(fh)["transformation"], dtype=torch.float32)
    clouds = [io.load_gaussian_cloud(os.path.join(DATA, f"demo_{name}.ply"), device="cpu")
              for name in ("source", "target")]
    loop = evaluation.evaluate_registration(*clouds, T, cams, str(tmp_path), use_lpips=False,
                                            device="cpu")
    sharded = evaluation.evaluate_registration_sharded(*clouds, T, cams, str(tmp_path),
                                                       device="cpu")
    assert not dist.is_initialized()
    assert sharded.error_list == loop.error_list and len(loop.error_list) == 2
    for key in ("mse", "rmse", "psnr", "ssim"):
        assert abs(getattr(sharded, key) - getattr(loop, key)) < 1e-5, key
    assert distributed.initialize(device="cpu") is True
    again = evaluation.evaluate_registration_sharded(*clouds, T, cams, str(tmp_path),
                                                     device="cpu")
    assert dist.is_initialized() and again.mse == sharded.mse
