"""Torch port vs JAX package: models (GaussianCloud, Camera, PointCloud) and
utils/io. Same seeded numpy inputs through both packages, on the CPU;
tolerance atol 1e-5 (f32 arithmetic in another order) unless stated.
"""

import json
import math
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gaussiansplattingregistration_tpu.models.camera import Camera as JCamera, look_at as j_look_at
from gaussiansplattingregistration_tpu.ops import se3
from gaussiansplattingregistration_tpu.utils import io as jio
from gaussiansplattingregistration_tpu_torch.models.camera import Camera, look_at
from gaussiansplattingregistration_tpu_torch.models.gaussian_cloud import GaussianCloud
from gaussiansplattingregistration_tpu_torch.models.point_cloud import PointCloud
from gaussiansplattingregistration_tpu_torch.utils import io as tio
from tests.conftest import make_random_cloud

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FIELDS = ("xyz", "features_dc", "features_rest", "opacity", "scaling", "rotation")
ATOL = 1e-5


def port(jcloud) -> GaussianCloud:
    return GaussianCloud.from_numpy_dict(jcloud.to_numpy_dict(), device="cpu")


def random_se3(rng):
    return np.asarray(se3.se3_exp(jnp.asarray(rng.normal(size=6).astype(np.float32))))


def assert_cloud_close(tcloud, jcloud, atol=ATOL):
    assert tcloud.sh_degree == jcloud.sh_degree
    for name in FIELDS + ("covariance",):
        np.testing.assert_allclose(getattr(tcloud, name).numpy(),
                                   np.asarray(getattr(jcloud, name)),
                                   atol=atol, err_msg=name)


def test_demo_ply_roundtrip_identical(tmp_path):
    src = os.path.join(DATA, "demo_source.ply")
    cloud = tio.load_gaussian_cloud(src, device="cpu")
    jcloud = jio.load_gaussian_cloud(src)
    assert cloud.sh_degree == jcloud.sh_degree == 1
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(cloud, name).numpy(),
                                      np.asarray(getattr(jcloud, name)), err_msg=name)
    path = str(tmp_path / "again.ply")
    tio.save_gaussian_cloud(cloud, path)
    again = tio.load_gaussian_cloud(path, device="cpu")
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(again, name).numpy(),
                                      getattr(cloud, name).numpy(), err_msg=name)
    with open(src, "rb") as f, open(path, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("sh_degree", [0, 1, 2, 3])
def test_from_numpy_dict_matches_jax_activations(rng, sh_degree):
    jcloud = make_random_cloud(rng, n=48, sh_degree=sh_degree)
    cloud = port(jcloud)
    assert_cloud_close(cloud, jcloud)
    for mod in (1.0, 0.6):
        np.testing.assert_allclose(cloud.get_covariance(mod).numpy(),
                                   np.asarray(jcloud.get_covariance(mod)), atol=ATOL)
    np.testing.assert_allclose(cloud.get_opacity.numpy(), np.asarray(jcloud.get_opacity), atol=ATOL)
    np.testing.assert_allclose(cloud.get_features.numpy(), np.asarray(jcloud.get_features), atol=ATOL)
    np.testing.assert_allclose(cloud.get_scaling.numpy(), np.asarray(jcloud.get_scaling), atol=ATOL)
    np.testing.assert_allclose(cloud.get_rotation.numpy(), np.asarray(jcloud.get_rotation), atol=ATOL)
    np.testing.assert_allclose(cloud.get_rgb.numpy(), np.asarray(jcloud.get_rgb), atol=ATOL)


@pytest.mark.parametrize("rotate_sh", [True, False])
def test_transform_matches_jax(rng, rotate_sh):
    jcloud = make_random_cloud(rng, n=48, sh_degree=3)
    T = random_se3(rng)
    got = port(jcloud).transform(T, rotate_sh=rotate_sh)
    want = jcloud.transform(jnp.asarray(T), rotate_sh=rotate_sh)
    assert_cloud_close(got, want)


def test_merge_matches_jax(rng):
    a = make_random_cloud(rng, n=40, sh_degree=2)
    b = make_random_cloud(rng, n=24, sh_degree=2)
    T = random_se3(rng)
    got = port(a).merge(port(b), T)
    want = a.merge(b, jnp.asarray(T))
    assert got.num_points == 64
    assert_cloud_close(got, want)
    plain = port(a).merge(port(b))
    assert_cloud_close(plain, a.merge(b))


def test_select_and_to_numpy_dict(rng):
    jcloud = make_random_cloud(rng, n=30, sh_degree=1)
    idx = np.array([3, 0, 17, 29])
    got = port(jcloud).select(torch.as_tensor(idx))
    assert_cloud_close(got, jcloud.select(jnp.asarray(idx)))
    d = got.to_numpy_dict()
    assert set(d) == set(FIELDS)
    assert_cloud_close(GaussianCloud.from_numpy_dict(d, device="cpu"), jcloud.select(jnp.asarray(idx)))


def test_sh_degree_mismatched_merge_raises(rng):
    a = port(make_random_cloud(rng, n=8, sh_degree=2))
    b = port(make_random_cloud(rng, n=8, sh_degree=1))
    with pytest.raises(ValueError, match="SH degree mismatch"):
        a.merge(b)


def test_garbage_ply_raises(tmp_path):
    path = tmp_path / "garbage.ply"
    path.write_bytes(b"this is not a ply file\n\x00\x01")
    with pytest.raises(ValueError, match="not a PLY file"):
        tio.load_gaussian_cloud(str(path), device="cpu")


def test_point_cloud_load_and_sniffing(tmp_path, rng):
    from gaussiansplattingregistration_tpu.models.point_cloud import PointCloud as JPointCloud

    pts = rng.normal(size=(20, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, size=(20, 3)).astype(np.float32)
    spath = str(tmp_path / "sparse.ply")
    jio.save_point_cloud(JPointCloud(points=jnp.asarray(pts), colors=jnp.asarray(cols)), spath)
    loaded = tio.load_point_cloud_any(spath, device="cpu")
    jloaded = jio.load_sparse_cloud(spath)
    assert isinstance(loaded, PointCloud) and loaded.normals is None
    np.testing.assert_array_equal(loaded.points.numpy(), np.asarray(jloaded.points))
    np.testing.assert_array_equal(loaded.colors.numpy(), np.asarray(jloaded.colors))
    gpath = os.path.join(DATA, "demo_target.ply")
    assert isinstance(tio.load_point_cloud_any(gpath, device="cpu"), GaussianCloud)
    T = random_se3(rng)
    np.testing.assert_allclose(loaded.transform(T).points.numpy(),
                               pts @ T[:3, :3].T + T[:3, 3], atol=ATOL)
    lo, hi = loaded.select(torch.tensor([0, 3])).aabb()
    np.testing.assert_array_equal(lo.numpy(), pts[[0, 3]].min(0))
    np.testing.assert_array_equal(hi.numpy(), pts[[0, 3]].max(0))


def test_gaussian_to_point_cloud_matches_jax(rng):
    jcloud = make_random_cloud(rng, n=32, sh_degree=1)
    got = tio.gaussian_to_point_cloud(port(jcloud))
    want = jio.gaussian_to_point_cloud(jcloud)
    for name in ("points", "colors", "covariances"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=ATOL, err_msg=name)
    with pytest.raises(NotImplementedError, match="normals"):
        tio.gaussian_to_point_cloud(port(jcloud), estimate_missing_normals=True)


def _camera_pair(rng):
    R = np.asarray(se3.se3_exp(jnp.asarray(rng.normal(size=6), jnp.float32)))[:3, :3]
    T = rng.normal(size=3).astype(np.float32)
    jcam = JCamera.create(R, T, 412.5, 398.0, 320, 240)
    cam = Camera.from_numpy(np.asarray(jcam.rotation), np.asarray(jcam.position),
                            float(jcam.fx), float(jcam.fy), jcam.width, jcam.height,
                            device="cpu")
    return cam, jcam


def test_camera_matches_jax(rng):
    cam, jcam = _camera_pair(rng)
    np.testing.assert_allclose(cam.intrinsics.numpy(), np.asarray(jcam.intrinsics), atol=ATOL)
    np.testing.assert_allclose(cam.viewmat.numpy(), np.asarray(jcam.viewmat), atol=ATOL)
    np.testing.assert_allclose(cam.cam_center.numpy(), np.asarray(jcam.cam_center), atol=ATOL)
    V = random_se3(rng).astype(np.float32)
    np.testing.assert_allclose(cam.with_viewmat(V).viewmat.numpy(),
                               np.asarray(jcam.with_viewmat(V).viewmat), atol=ATOL)


def test_camera_from_json_entry_and_look_at_match_jax(rng):
    R = np.asarray(se3.se3_exp(jnp.asarray(rng.normal(size=6), jnp.float32)))[:3, :3]
    entry = {"img_name": "r_0", "width": 800, "height": 600, "fx": 700.0, "fy": 690.0,
             "rotation": R.tolist(), "position": [0.3, -0.2, -3.0]}
    cam = Camera.from_json_entry(json.loads(json.dumps(entry)), device="cpu")
    jcam = JCamera.from_json_entry(entry)
    assert (cam.image_name, cam.width, cam.height) == ("r_0", 800, 600)
    np.testing.assert_allclose(cam.viewmat.numpy(), np.asarray(jcam.viewmat), atol=ATOL)
    np.testing.assert_allclose(cam.intrinsics.numpy(), np.asarray(jcam.intrinsics), atol=ATOL)
    for forward in ("+z", "-z"):
        got = look_at([1.0, 2.0, -3.0], [0.1, 0.0, 0.2], [0.0, -1.0, 0.0], zoom=2.0,
                      forward=forward, device="cpu")
        want = j_look_at([1.0, 2.0, -3.0], [0.1, 0.0, 0.2], [0.0, -1.0, 0.0], zoom=2.0,
                         forward=forward)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert math.isclose(float(cam.fy), 690.0)


def test_entry_points_default_to_cuda(monkeypatch):
    """With no card and no explicit CPU request the models raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Camera.create(np.eye(3), np.zeros(3), 100.0, 100.0, 64, 48)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tio.load_gaussian_cloud(os.path.join(DATA, "demo_source.ply"))
