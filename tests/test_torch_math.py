"""Torch port vs JAX package: ops/math3d.py and ops/sh.py.

Same seeded numpy inputs through both packages; tolerance atol 1e-5 (f32
arithmetic in another order), on the CPU.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gaussiansplattingregistration_tpu.ops import math3d as jm, sh as jsh
from gaussiansplattingregistration_tpu_torch.ops import math3d as tm, sh as tsh

ATOL = 1e-5


def both(fn_j, fn_t, *arrays):
    got = fn_t(*(torch.as_tensor(np.array(a)) for a in arrays))
    want = fn_j(*(jnp.asarray(a) for a in arrays))
    return np.asarray(got), np.asarray(want)


def rand_quats(rng, n):
    return rng.normal(size=(n, 4)).astype(np.float32)


def rand_rotmat(rng):
    q = rng.normal(size=4)
    return np.asarray(jm.quat_to_rotmat(jnp.asarray(q / np.linalg.norm(q), jnp.float32)))


@pytest.mark.parametrize("name", [
    "quat_to_rotmat", "normalize", "pack_unpack", "quat_multiply",
    "covariance_from_scaling_rotation", "axis_angle_to_rotmat",
    "transform_covariance", "make_se3", "inverse_sigmoid", "rotmat_to_quat",
    "kabsch_rotation",
])
def test_math3d_matches_jax(rng, name):
    n = 64
    q = rand_quats(rng, n)
    if name == "quat_to_rotmat":
        got, want = both(jm.quat_to_rotmat, tm.quat_to_rotmat, q)
    elif name == "normalize":
        got, want = both(jm.normalize, tm.normalize, rng.normal(size=(n, 3)).astype(np.float32))
    elif name == "pack_unpack":
        v = rng.normal(size=(n, 6)).astype(np.float32)
        got, want = both(lambda x: jm.pack_symmetric(jm.unpack_symmetric(x) * 2.0),
                         lambda x: tm.pack_symmetric(tm.unpack_symmetric(x) * 2.0), v)
    elif name == "quat_multiply":
        got, want = both(jm.quat_multiply, tm.quat_multiply, q, rand_quats(rng, n))
    elif name == "covariance_from_scaling_rotation":
        s = rng.uniform(0.01, 2.0, size=(n, 3)).astype(np.float32)
        got, want = both(lambda a, b: jm.covariance_from_scaling_rotation(a, b, 0.7),
                         lambda a, b: tm.covariance_from_scaling_rotation(a, b, 0.7), s, q)
    elif name == "axis_angle_to_rotmat":
        axis = rng.normal(size=(n, 3)).astype(np.float32)
        ang = rng.uniform(-np.pi, np.pi, size=n).astype(np.float32)
        got, want = both(jm.axis_angle_to_rotmat, tm.axis_angle_to_rotmat, axis, ang)
    elif name == "transform_covariance":
        cov = np.asarray(jm.covariance_from_scaling_rotation(
            jnp.asarray(rng.uniform(0.1, 1.0, size=(n, 3)), jnp.float32), jnp.asarray(q)))
        got, want = both(jm.transform_covariance, tm.transform_covariance, cov, rand_rotmat(rng))
    elif name == "make_se3":
        got, want = both(jm.make_se3, tm.make_se3, rand_rotmat(rng),
                         rng.normal(size=3).astype(np.float32))
    elif name == "inverse_sigmoid":
        got, want = both(jm.inverse_sigmoid, tm.inverse_sigmoid,
                         rng.uniform(0.01, 0.99, size=n).astype(np.float32))
    elif name == "rotmat_to_quat":
        # Includes 180-degree rotations (the Shepperd branches).
        mats = np.stack([rand_rotmat(rng) for _ in range(16)]
                        + [np.diag([1.0, -1.0, -1.0]).astype(np.float32),
                           np.diag([-1.0, 1.0, -1.0]).astype(np.float32)])
        got, want = both(jm.rotmat_to_quat, tm.rotmat_to_quat, mats)
    else:  # kabsch_rotation
        H = rng.normal(size=(8, 3, 3)).astype(np.float32)
        got, want = both(jm.kabsch_rotation, tm.kabsch_rotation, H)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_decompose_covariance_reconstructs(rng):
    """Eigenvector signs may differ between LAPACK calls, so compare what the
    decomposition means: Σ = R diag(s²) Rᵀ, with a proper rotation."""
    q = rand_quats(rng, 32)
    s = rng.uniform(0.1, 1.0, size=(32, 3)).astype(np.float32)
    cov = tm.covariance_from_scaling_rotation(torch.as_tensor(s), torch.as_tensor(q))
    scales, quats = tm.decompose_covariance(cov)
    back = tm.covariance_from_scaling_rotation(scales, quats)
    np.testing.assert_allclose(back.numpy(), cov.numpy(), atol=ATOL)
    js, _ = jm.decompose_covariance(jnp.asarray(cov.numpy()))
    np.testing.assert_allclose(scales.numpy(), np.asarray(js), atol=ATOL)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh_matches_jax(rng, degree):
    n = 64
    k = (degree + 1) ** 2
    coeffs = rng.normal(size=(n, k, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32)
    got, want = both(lambda c, d: jsh.eval_sh(degree, c, d),
                     lambda c, d: tsh.eval_sh(degree, c, d), coeffs, dirs)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_rotate_sh_matches_jax(rng, degree):
    n = 32
    k_rest = (degree + 1) ** 2 - 1
    rest = rng.normal(size=(n, k_rest, 3)).astype(np.float32)
    R = rand_rotmat(rng)
    got, want = both(lambda f, r: jsh.rotate_sh(f, r, degree),
                     lambda f, r: tsh.rotate_sh(f, r, degree), rest, R)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_sh_rgb_roundtrip_matches_jax(rng):
    x = rng.normal(size=(16, 3)).astype(np.float32)
    got, want = both(jsh.sh2rgb, tsh.sh2rgb, x)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(tsh.rgb2sh(torch.as_tensor(got)).numpy(), x, atol=ATOL)
