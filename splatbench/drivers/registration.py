"""Driver of the registration cells: a closed loop of registration jobs.

Each job takes the reference capture moved by a rigid motion drawn from the
seed (a new capture of the same scene to align) and registers it against
the reference capture, its pose ending on the host:
- `method` "hem": `hem.create_mixture` on the moved capture (with a HEM
  seed of its own), then `multiscale_mixture_registration` against the
  reference's pyramid, built once in set-up;
- `method` "voxel": `multiscale_voxel_registration` of the two captures'
  points (a voxel pyramid with normals at each scale, then ICP).

Traffic parameters (`traffic/<mix>.json`): `method`, `motions` (how many
motions there are; jobs cycle through them), `motion_seed` (the numpy
seed that draws them), `translation` and `angle_deg` (every motion's
sizes). Every run has the same motions, in an order drawn from its seed,
so that the seed changes the scene's draw and not the window's work.
Also `warmup_jobs`, `trace_steps` (jobs in the traced window),
`check_jobs` (jobs the reference runs again, drawn from the seed among
those the window completed) and `limits`.

The configuration gives the scene (`scene`, `splats`) and the
registration parameters: `hem` (GaussianMixtureParams' fields) and
`multiscale` (`voxel_values`, `iter_values`).

Control (`--control`): "tf32", the reference in the program's place in
float32 with TF32 matmuls.
"""

from __future__ import annotations

import dataclasses
import math
import sys

import numpy as np
import torch

from gaussiansplattingregistration_tpu_torch.models import parameters as port_params
from gaussiansplattingregistration_tpu_torch.models.gaussian_cloud import GaussianCloud
from gaussiansplattingregistration_tpu_torch.models.point_cloud import PointCloud as PortPointCloud
from gaussiansplattingregistration_tpu_torch.ops import hem as port_hem
from gaussiansplattingregistration_tpu_torch.pipelines import multiscale as port_multiscale
from splatbench import scenes
from splatbench.common import Spans
from splatbench.reference import raster as ref_raster
from splatbench.reference import registration as ref


@dataclasses.dataclass
class State:
    ctx: object
    method: str
    raw: dict
    motions: list
    hem_seeds: list
    spans: Spans
    side: object
    target: object = None
    results: list = dataclasses.field(default_factory=list)


class _Port:
    """The program's registration path."""

    def __init__(self, cfg: dict, device):
        self.device = device
        self.hem_params = port_params.GaussianMixtureParams(**cfg["hem"])
        self.ms_params = port_params.MultiScaleRegistrationParams(**cfg["multiscale"])
        self.sh_degree = int(cfg["scene"]["sh_degree"])

    def cloud(self, raw):
        return GaussianCloud.create(raw["xyz"], raw["features_dc"], raw["features_rest"],
                                    raw["opacity"], raw["scaling"], raw["rotation"],
                                    sh_degree=self.sh_degree, covariance=raw["covariance"],
                                    device=self.device)

    def hem(self, cloud, seed):
        return port_hem.create_mixture(cloud, self.hem_params, seed=seed, backend="torch")

    def pyramid(self, cloud, levels):
        dev = self.device
        return [PortPointCloud(points=cloud.xyz, colors=cloud.get_colors)] + [
            PortPointCloud(points=torch.as_tensor(lv.xyz, device=dev),
                           colors=torch.as_tensor(lv.colors, device=dev)) for lv in levels]

    def points(self, cloud):
        return PortPointCloud(points=cloud.xyz, colors=cloud.get_colors)

    def mixture_registration(self, src_levels, tgt_levels):
        return port_multiscale.multiscale_mixture_registration(src_levels, tgt_levels,
                                                               self.ms_params)

    def voxel_registration(self, src, tgt):
        return port_multiscale.multiscale_voxel_registration(src, tgt, self.ms_params)


class _Control(ref.Reference):
    """The reference in the program's place, in float32 with TF32 matmuls."""

    def __init__(self, cfg: dict, device):
        super().__init__(cfg, device, dtype=torch.float32)

    def _tf32(self, fn, *args):
        with ref_raster.precision(tf32=True):
            return fn(*args)

    def hem(self, cloud, seed):
        return self._tf32(super().hem, cloud, seed)

    def mixture_registration(self, src_levels, tgt_levels):
        return self._tf32(super().mixture_registration, src_levels, tgt_levels)

    def voxel_registration(self, src, tgt):
        return self._tf32(super().voxel_registration, src, tgt)


def setup(ctx) -> State:
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    if tr["method"] not in ("hem", "voxel"):
        raise ValueError(f"unknown registration method {tr['method']!r}")
    raw = scenes.reg_scene(cfg["scene"], cfg["splats"], ctx.seed, dev)
    rng = np.random.default_rng(int(ctx.seed) % (2 ** 63))
    n = int(tr["motions"])
    fixed = scenes.rigid_motions(int(tr["motion_seed"]), n, tr["translation"], tr["angle_deg"])
    motions = [fixed[i] for i in rng.permutation(n)]
    hem_seeds = [int(s) for s in rng.integers(0, 2 ** 31, size=n + int(tr["warmup_jobs"]) + 1)]
    side = _Control(cfg, dev) if ctx.control == "tf32" else _Port(cfg, dev)
    if ctx.control not in (None, "tf32"):
        raise ValueError(f"unknown registration control {ctx.control!r}")
    st = State(ctx=ctx, method=tr["method"], raw=raw, motions=motions, hem_seeds=hem_seeds,
               spans=Spans(ctx), side=side)
    st.target = _target(st, side)
    for j in range(int(tr["warmup_jobs"])):
        _job(st, side, motions[j % n], hem_seeds[n + j], st.target)
    return st


def _target(st: State, side):
    """The reference capture's side of every job: its HEM pyramid (seeded
    with the run's last HEM seed) or its points."""
    cloud = side.cloud(st.raw)
    if st.method == "hem":
        return side.pyramid(cloud, side.hem(cloud, st.hem_seeds[-1]))
    return side.points(cloud)


def _job(st: State, side, motion, hem_seed: int, target, spans=None, levels=None) -> dict:
    """One job on `side` (the program, the control or the reference): the
    capture moved by `motion`, registered against `target` (from HEM
    `levels` of the moved capture where they are given)."""
    moved = side.cloud(scenes.move_capture(st.raw, motion))

    def timed(name, fn, *args):
        return spans.run(name, fn, *args) if spans else fn(*args)

    if st.method == "hem":
        if levels is None:
            levels = timed("hem", side.hem, moved, hem_seed)
        res = timed("multiscale", side.mixture_registration, side.pyramid(moved, levels),
                    target)
    else:
        res = timed("multiscale", side.voxel_registration, side.points(moved), target)
    return {"motion": motion, "hem_seed": hem_seed, "levels": levels,
            "pose": np.asarray(res.transformation, np.float64), "fitness": float(res.fitness),
            "rmse": float(res.inlier_rmse), "iterations": getattr(res, "iterations", None)}


def step(st: State, i: int) -> None:
    n = int(st.ctx.traffic["motions"])
    st.results.append({"job": i, **_job(st, st.side, st.motions[i % n], st.hem_seeds[i % n],
                                        st.target, st.spans)})


def window_metrics(st: State, window_s: float, steps: int) -> dict:
    return {"register_s": window_s / steps}


def spans(st: State) -> dict:
    return {k: list(v) for k, v in st.spans.seconds.items()}


def _pose_gap(a: np.ndarray, b: np.ndarray) -> tuple:
    """(rotation angle of a b⁻¹ in degrees, translation distance) between two
    4x4 poses."""
    d = a @ np.linalg.inv(b)
    axis = np.array([d[2, 1] - d[1, 2], d[0, 2] - d[2, 0], d[1, 0] - d[0, 1]])
    angle = math.atan2(0.5 * float(np.linalg.norm(axis)), 0.5 * (np.trace(d[:3, :3]) - 1.0))
    return math.degrees(angle), float(np.linalg.norm(a[:3, 3] - b[:3, 3]))


def _level_gap(got, want) -> float:
    """The largest gap between two HEM pyramids' levels, relative to each
    field's largest magnitude; inf where a level's size differs."""
    worst = 0.0
    for lg, lw in zip(got, want):
        for field in ("xyz", "colors", "opacities", "covariance", "features"):
            a, b = np.asarray(getattr(lg, field)), np.asarray(getattr(lw, field))
            if a.shape != b.shape:
                return math.inf
            if b.size:
                scale = max(float(np.abs(b).max()), 1e-30)
                worst = max(worst, float(np.abs(a - b).max()) / scale)
    return worst


def check(st: State) -> dict:
    """Every job's pose against the motion the benchmark applied (the
    configuration's guarantee), and a sample of jobs drawn from the seed
    run again by the reference from the same raw inputs: their final poses
    (and, printed, HEM's levels and the pose under Open3D's stop test)."""
    nums = {"truth_rot_err_deg": 0.0, "truth_trans_err": 0.0}
    for r in st.results:
        rot, trans = _pose_gap(r["pose"] @ r["motion"], np.eye(4))
        nums["truth_rot_err_deg"] = max(nums["truth_rot_err_deg"], rot)
        nums["truth_trans_err"] = max(nums["truth_trans_err"], trans)
    rng = np.random.default_rng((int(st.ctx.seed) + 7) % (2 ** 63))
    k = min(int(st.ctx.traffic["check_jobs"]), len(st.results))
    picks = sorted(rng.choice(len(st.results), size=k, replace=False).tolist())
    reference = ref.Reference(st.ctx.config, st.ctx.device)
    open3d = ref.Reference(st.ctx.config, st.ctx.device, late_stop=False)
    with ref_raster.precision(tf32=False):
        target = _target(st, reference)
        nums.update({"pose_rot_gap_deg": 0.0, "pose_trans_gap": 0.0})
        if st.method == "hem":
            nums["level_gap"] = 0.0
        for i in picks:
            r = st.results[i]
            want = _job(st, reference, r["motion"], r["hem_seed"], target)
            rot, trans = _pose_gap(r["pose"], want["pose"])
            early = _job(st, open3d, r["motion"], r["hem_seed"], target, levels=want["levels"])
            nums["open3d_stop_rot_gap_deg"] = max(nums.get("open3d_stop_rot_gap_deg", 0.0),
                                                  _pose_gap(r["pose"], early["pose"])[0])
            nums["pose_rot_gap_deg"] = max(nums["pose_rot_gap_deg"], rot)
            nums["pose_trans_gap"] = max(nums["pose_trans_gap"], trans)
            line = {"job": r["job"], "rot_gap_deg": rot, "trans_gap": trans,
                    "fitness": [r["fitness"], want["fitness"]], "rmse": [r["rmse"], want["rmse"]],
                    "reference_updates": want["iterations"]}
            if st.method == "hem":
                gap = _level_gap(r["levels"], want["levels"])
                nums["level_gap"] = max(nums["level_gap"], gap)
                line["level_gap"] = gap
                line["level_sizes"] = [[len(lv.xyz) for lv in r["levels"]],
                                       [len(lv.xyz) for lv in want["levels"]]]
            print(f"# reference job: {line}", file=sys.stderr)
    return nums
