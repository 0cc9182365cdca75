"""The registration cells' reference (`reference/registration.py`): each
of its parts against a brute or closed-form answer, and its ICP's two
stopping rules."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from splatbench.reference import registration as ref


def _rigid(seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    a = math.radians(rng.uniform(1, 20))
    T = np.eye(4)
    T[:3, :3] = np.eye(3) + math.sin(a) * K + (1 - math.cos(a)) * (K @ K)
    T[:3, 3] = rng.normal(size=3) * 0.1
    return torch.tensor(T)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kabsch_recovers_a_rigid_motion(seed):
    p = torch.tensor(np.random.default_rng(seed).normal(size=(50, 3)))
    T = _rigid(seed)
    q = p @ T[:3, :3].T + T[:3, 3]
    assert torch.allclose(ref.kabsch(p, q), T, atol=1e-12)


def test_nearest_equals_a_brute_argmin():
    rng = np.random.default_rng(5)
    p, q = torch.tensor(rng.normal(size=(300, 3))), torch.tensor(rng.normal(size=(200, 3)))
    d2, idx = ref.nearest(p, q, block=64)
    full = ((p[:, None, :] - q[None, :, :]) ** 2).sum(-1)
    assert torch.equal(idx, full.argmin(1)) and torch.allclose(d2, full.min(1).values)


def test_voxel_downsample_averages_each_occupied_voxel():
    pts = torch.tensor(np.random.default_rng(6).uniform(0, 1, size=(500, 3)))
    got = ref.voxel_downsample(pts, 0.25)
    cells = {}
    lo = pts.min(0).values
    for row in pts:
        cells.setdefault(tuple(torch.floor((row - lo) / 0.25).long().tolist()), []).append(row)
    want = torch.stack([torch.stack(v).mean(0) for v in cells.values()])
    assert got.shape == want.shape
    order = lambda x: x[np.lexsort(x.numpy().T[::-1])]  # noqa: E731
    assert torch.allclose(order(got), order(want), atol=1e-12)


def test_icp_recovers_a_small_motion_and_stops_one_update_late():
    pts = torch.tensor(np.random.default_rng(7).uniform(-1, 1, size=(400, 3)))
    T = _rigid(3)
    T[:3, :3] = torch.tensor(np.eye(3))
    T[:3, 3] = torch.tensor([0.01, -0.02, 0.015])
    src = pts @ T[:3, :3].T - T[:3, :3].T @ T[:3, 3]                 # T⁻¹ applied
    eye = torch.eye(4, dtype=torch.float64)
    late = ref.icp(src, pts, 0.5, 30, eye)
    early = ref.icp(src, pts, 0.5, 30, eye, late_stop=False)
    assert torch.allclose(late[0], T, atol=1e-9) and late[1] == 1.0
    assert late[3] == early[3] + 1 < 30
