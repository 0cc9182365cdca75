"""`splatbench/scenes.py`: its frozen numpy draws reproduce the bench
scenes' draws bit for bit, and `--seed` maps onto the device draws
deterministically (the same seed, the same scene; another seed, another)."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from splatbench import scenes

N = 2048


@pytest.mark.parametrize("name", ["uniform_draws", "clustered_draws"])
def test_numpy_draws_equal_the_bench_draws_bit_for_bit(name):
    import bench_torch

    ours = getattr(scenes, name + "_np")(N)
    theirs = getattr(bench_torch, name)(N)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_registration_draws_equal_the_bench_cloud_bit_for_bit():
    import bench_torch

    ours = scenes.hem_cloud_np(N)
    cloud = bench_torch.hem_cloud(N, torch.device("cpu"))
    for key in ("xyz", "features_dc", "features_rest", "opacity", "scaling", "rotation"):
        theirs = getattr(cloud, key).numpy()
        assert np.array_equal(ours[key].reshape(theirs.shape), theirs), key


SPLAT = {"draw": "uniform", "splats": 500, "sh_degree": 3, "xyz_range": [-1.0, 1.0],
         "scale_range": [0.002, 0.006], "dc_std": 0.3, "rest_std": 0.1, "opacity_logit_std": 1.0}
REG = json.load(open(os.path.join(os.path.dirname(__file__), "..", "configs",
                            "reg200k_sh3.json")))["scene"]


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5, 3 * 2 ** 62])
def test_a_seed_gives_one_scene(seed):
    a = scenes.splat_scene(SPLAT, seed, "cpu")
    b = scenes.splat_scene(SPLAT, seed, "cpu")
    c = scenes.splat_scene(SPLAT, seed + 1, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    r1, r2 = scenes.reg_scene(REG, 500, seed, "cpu"), scenes.reg_scene(REG, 500, seed, "cpu")
    assert all(torch.equal(r1[k], r2[k]) for k in r1)


def test_scene_shapes_and_ranges():
    means, cov6, opacity, feats = scenes.splat_scene(SPLAT, 7, "cpu")
    assert means.shape == (500, 3) and cov6.shape == (500, 6) and feats.shape == (500, 16, 3)
    assert float(means.abs().max()) <= 1.0 and 0 < float(opacity.min()) < float(opacity.max()) < 1
    # Each covariance is positive definite with eigenvalues scales squared.
    full = torch.stack([cov6[:, 0], cov6[:, 1], cov6[:, 2], cov6[:, 1], cov6[:, 3], cov6[:, 4],
                        cov6[:, 2], cov6[:, 4], cov6[:, 5]], -1).reshape(-1, 3, 3)
    ev = torch.linalg.eigvalsh(full.double())
    assert float(ev.min()) > 0.002 ** 2 * 0.99 and float(ev.max()) < 0.006 ** 2 * 1.01


def test_motions_have_the_stated_sizes():
    for T in scenes.rigid_motions(3_000_000_001, 64, 0.06, 3.0):
        assert np.allclose(T[:3, :3] @ T[:3, :3].T, np.eye(3), atol=1e-12)
        angle = np.degrees(np.arccos(np.clip((np.trace(T[:3, :3]) - 1) / 2, -1, 1)))
        assert abs(angle - 3.0) < 1e-6 and abs(np.linalg.norm(T[:3, 3]) - 0.06) < 1e-12


def test_room_splats_lie_flat_on_the_faces():
    raw = scenes.reg_scene(REG, 4000, 11, "cpu")
    faces = scenes._faces(REG)
    xyz = raw["xyz"].double().numpy()
    # Each splat's distance to the nearest face plane within that face's extent.
    centre, normal, t1 = faces[:, 0:3], faces[:, 3:6], faces[:, 6:9]
    t2, half = np.cross(normal, t1), faces[:, 9:11]
    rel = xyz[:, None, :] - centre[None]
    off = np.abs((rel * normal).sum(-1))
    inside = ((np.abs((rel * t1).sum(-1)) <= half[:, 0] + 1e-6)
              & (np.abs((rel * t2).sum(-1)) <= half[:, 1] + 1e-6))
    dist = np.where(inside, off, np.inf).min(1)
    assert float(dist.max()) < 6 * REG["normal_jitter"]
    # The covariance's smallest axis is the face's normal, at the normal scale.
    c = raw["covariance"].double()
    full = torch.stack([c[:, 0], c[:, 1], c[:, 2], c[:, 1], c[:, 3], c[:, 4],
                        c[:, 2], c[:, 4], c[:, 5]], -1).reshape(-1, 3, 3)
    ev, vec = torch.linalg.eigh(full)
    n_lo, n_hi = REG["normal_scale"]
    assert float(ev[:, 0].min()) > n_lo ** 2 * 0.99 and float(ev[:, 0].max()) < n_hi ** 2 * 1.01
    # (Near an edge the nearest plane can be the neighbouring face's.)
    face = np.where(inside, off, np.inf).argmin(1)
    cosine = np.abs((vec[:, :, 0].numpy() * normal[face]).sum(-1))
    assert float(np.mean(cosine > 0.999)) > 0.98
    assert raw["features_rest"].shape == (4000, 15, 3)
