"""Rank processes for the port's multi-process tests on the CPU.

Importing this module has no side effect. `run_group(world, cases, tmp_dir)`
pickles the cases, starts `world` processes of this module (`python -m
tests.torch_dist_workers DIR`) with torchrun's `RANK`, `WORLD_SIZE` and
`LOCAL_RANK` set, and returns rank 0's results. Each rank joins a gloo
group through `distributed.initialize` on a `FileStore` under DIR (so
concurrent test workers never race for a port), with one torch thread, and
runs every case in order; the groups a case's mesh needs are made by every
rank in the same order. The ranks import torch and the port only.

A case is a dict with `kind`, `mesh` (data, splat) and numpy inputs:
`cloud` (raw arrays, `covariance` and `sh_degree`), `camera` (R, T, fx, fy,
width, height), `config` (RasterizeConfig fields), and per kind:

* "render": `compositor` ("all_gather" or "depth_sharded"), `background`,
  `capacity_slack` -> rgb, alpha, depth (and dropped);
* "render_grad": d sum(rgb) / d means over the whole cloud -> grad;
* "train_step": `cameras`, `targets`, `xi0`, `steps`, `compositor`,
  `capacity_slack` -> per step loss, xi, the xi gradient and dropped;
* "eval": `cameras`, `images`, `background` -> the sharded means;
* "mesh": the mesh's sizes and coordinates and a gather over each axis;
* "psum": the sum over all ranks of each rank's slice of arange(8).
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_group(world: int, cases: dict, tmp_dir: str, timeout: float = 600) -> dict:
    """Run `cases` ({name: case}) on `world` gloo ranks; rank 0's results."""
    os.makedirs(tmp_dir, exist_ok=True)
    with open(os.path.join(tmp_dir, "cases.pkl"), "wb") as f:
        pickle.dump(cases, f)
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT")}
    procs = []
    for rank in range(world):
        env_r = dict(env, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                     OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests.torch_dist_workers", tmp_dir], cwd=REPO, env=env_r,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {rank} failed (rc {p.returncode}):\n{out[-2000:]}\n"
                                 f"{err[-4000:]}")
    with open(os.path.join(tmp_dir, "results.pkl"), "rb") as f:
        return pickle.load(f)


def cloud_case(jcloud) -> dict:
    """A JAX GaussianCloud's raw arrays, covariance and SH degree as numpy."""
    return {**jcloud.to_numpy_dict(), "covariance": np.asarray(jcloud.covariance),
            "sh_degree": jcloud.sh_degree}


def camera_case(jcam) -> dict:
    """A JAX Camera's fields as numpy and numbers."""
    return {"R": np.asarray(jcam.rotation), "T": np.asarray(jcam.position),
            "fx": float(jcam.fx), "fy": float(jcam.fy), "width": jcam.width,
            "height": jcam.height}


def port_cloud(d):
    """The port's GaussianCloud on the CPU from `cloud_case`'s dict."""
    from gaussiansplattingregistration_tpu_torch.models.gaussian_cloud import GaussianCloud

    return GaussianCloud.create(d["xyz"], d["features_dc"], d["features_rest"], d["opacity"],
                                d["scaling"], d["rotation"], sh_degree=int(d["sh_degree"]),
                                covariance=d["covariance"], device="cpu")


def port_camera(c):
    """The port's Camera on the CPU from `camera_case`'s dict."""
    from gaussiansplattingregistration_tpu_torch.models.camera import Camera

    return Camera.create(c["R"], c["T"], c["fx"], c["fy"], c["width"], c["height"],
                         device="cpu")


def single_device_step(cloud: dict, cameras, targets, xi0, config: dict):
    """The train step's loss and xi gradient through the port's
    single-device `rasterize_arrays` on the CPU: the squared error of
    clip(rgb) summed over cameras, pixels and channels, over C * H * W * 3.
    Returns (loss, grad [6])."""
    import torch

    from gaussiansplattingregistration_tpu_torch.ops import math3d, se3
    from gaussiansplattingregistration_tpu_torch.ops.rasterize import (
        RasterizeConfig,
        rasterize_arrays,
    )

    c = port_cloud(cloud)
    cams = [port_camera(cam) for cam in cameras]
    xi = torch.tensor(np.asarray(xi0, np.float32), requires_grad=True)
    T = se3.se3_exp(xi)
    R = T[:3, :3]
    means = c.xyz @ R.T + T[:3, 3]
    cov = math3d.transform_covariance(c.covariance, R)
    width, height = cams[0].width, cams[0].height
    loss = 0.0
    for cam, tgt in zip(cams, targets):
        rgb = rasterize_arrays(means, cov, c.get_opacity[:, 0], c.get_features, cam.viewmat,
                               cam.intrinsics, width, height, c.sh_degree, torch.zeros(3),
                               RasterizeConfig(**config), device="cpu")[0]
        loss = loss + torch.sum((torch.clamp(rgb, 0.0, 1.0) - torch.as_tensor(tgt)) ** 2)
    loss = loss / (len(cams) * height * width * 3.0)
    loss.backward()
    return float(loss.detach()), xi.grad.numpy()


# ----------------------------------------------------------------- ranks

def _config(fields):
    from gaussiansplattingregistration_tpu_torch.ops.rasterize import RasterizeConfig

    return RasterizeConfig(**fields)


def _np(t):
    import torch

    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _gather_rows(x, group):
    """Every rank's rows of `x`, concatenated in group-rank order."""
    import torch

    from gaussiansplattingregistration_tpu_torch.parallel import collectives

    with torch.no_grad():
        return collectives.all_gather(x.detach(), group)


def _render(case, mesh):
    from gaussiansplattingregistration_tpu_torch.parallel.compositor import rasterize_depth_sharded
    from gaussiansplattingregistration_tpu_torch.parallel.sharded_raster import rasterize_sharded

    cloud, cam, cfg = port_cloud(case["cloud"]), port_camera(case["camera"]), _config(case["config"])
    if case["compositor"] == "depth_sharded":
        out = rasterize_depth_sharded(cloud, cam, mesh, background=case["background"],
                                      config=cfg, capacity_slack=case["capacity_slack"],
                                      device="cpu")
        return dict(zip(("rgb", "alpha", "depth", "dropped"), map(_np, out)))
    out = rasterize_sharded(cloud, cam, mesh, background=case["background"], config=cfg,
                            device="cpu")
    return dict(zip(("rgb", "alpha", "depth"), map(_np, out)))


def _render_grad(case, mesh):
    from gaussiansplattingregistration_tpu_torch.parallel.compositor import (
        rasterize_arrays_depth_sharded,
    )
    from gaussiansplattingregistration_tpu_torch.parallel.sharded_raster import (
        rasterize_arrays_sharded,
        shard_splats,
    )

    cloud, cam, cfg = port_cloud(case["cloud"]), port_camera(case["camera"]), _config(case["config"])
    s = shard_splats(cloud, mesh, device="cpu")
    means = s["means"].clone().requires_grad_(True)
    args = (means, s["cov"], s["opacity"], s["features"], cam.viewmat, cam.intrinsics,
            cam.width, cam.height, cloud.sh_degree, (0.0, 0.0, 0.0), cfg)
    if case["compositor"] == "depth_sharded":
        rgb = rasterize_arrays_depth_sharded(*args, mesh=mesh, device="cpu",
                                             capacity_slack=case["capacity_slack"])[0]
    else:
        rgb = rasterize_arrays_sharded(*args, mesh=mesh, device="cpu")[0]
    rgb.sum().backward()
    grad = _gather_rows(means.grad, mesh.get_group("splat"))
    return {"grad": _np(grad)[:cloud.num_points]}


def _train_step(case, mesh):
    import torch

    from gaussiansplattingregistration_tpu_torch.parallel.train_step import (
        make_photometric_train_step,
        shard_splats,
    )

    cloud, cfg = port_cloud(case["cloud"]), _config(case["config"])
    cams = [port_camera(c) for c in case["cameras"]]
    width, height = cams[0].width, cams[0].height
    step, init, pad_targets = make_photometric_train_step(
        mesh, width, height, cloud.sh_degree, cfg, compositor=case["compositor"],
        capacity_slack=case["capacity_slack"], device="cpu")
    splats = shard_splats(cloud, mesh, device="cpu")
    viewmats = torch.stack([c.viewmat for c in cams])
    intrinsics = torch.stack([c.intrinsics for c in cams])
    targets = pad_targets(case["targets"])
    xi, opt = init(case["xi0"])
    out = {"loss": [], "xi": [], "grad": [], "dropped": []}
    for _ in range(case["steps"]):
        xi, opt, loss, dropped = step(xi, opt, splats, viewmats, intrinsics, targets)
        out["loss"].append(float(loss))
        out["xi"].append(_np(xi).copy())
        out["grad"].append(_np(xi.grad).copy())
        out["dropped"].append(int(dropped))
    return out


def _eval(case, mesh):
    from gaussiansplattingregistration_tpu_torch.parallel.sharded_eval import (
        evaluate_images_sharded,
    )

    cams = [port_camera(c) for c in case["cameras"]]
    return evaluate_images_sharded(port_cloud(case["cloud"]), cams, list(case["images"]), mesh,
                                   background=case["background"],
                                   config=_config(case["config"]), device="cpu")


def _mesh(case, mesh):
    import torch
    import torch.distributed as dist

    from gaussiansplattingregistration_tpu_torch.parallel.mesh import axis_size

    out = {"world": dist.get_world_size(), "rank": dist.get_rank()}
    for axis in ("data", "splat"):
        g = mesh.get_group(axis)
        out[axis] = {"size": axis_size(mesh, axis), "rank": mesh.get_local_rank(axis),
                     "group_rank": dist.get_rank(g),
                     "gathered": _np(_gather_rows(torch.tensor([float(dist.get_rank())]), g))}
    return out


def _psum(case, mesh):
    import torch
    import torch.distributed as dist

    from gaussiansplattingregistration_tpu_torch.parallel import collectives

    n, r = dist.get_world_size(), dist.get_rank()
    x = torch.arange(8.0).reshape(n, -1)[r]
    return {"total": float(collectives.all_reduce(x.sum(), "sum"))}


_KINDS = {"render": _render, "render_grad": _render_grad, "train_step": _train_step,
          "eval": _eval, "mesh": _mesh, "psum": _psum}


def _rank_main(tmp_dir: str) -> None:
    import torch

    from gaussiansplattingregistration_tpu_torch.parallel import distributed
    from gaussiansplattingregistration_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    with open(os.path.join(tmp_dir, "cases.pkl"), "rb") as f:
        cases = pickle.load(f)
    distributed.initialize(device="cpu",
                           init_method="file://" + os.path.join(tmp_dir, "store"))
    try:
        results = {}
        for name, case in cases.items():
            mesh = make_mesh(*case["mesh"])
            results[name] = _KINDS[case["kind"]](case, mesh)
        results["_primary"] = distributed.is_primary()
        if distributed.is_primary():
            with open(os.path.join(tmp_dir, "results.pkl"), "wb") as f:
                pickle.dump(results, f)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    _rank_main(sys.argv[1])
