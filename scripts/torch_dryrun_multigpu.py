"""One sharded photometric train step of the PyTorch port on N ranks, with
both compositors: the counterpart of `__graft_entry__.dryrun_multichip`.

    python scripts/torch_dryrun_multigpu.py 4                       # 4 gloo ranks, CPU
    torchrun --nproc-per-node 4 scripts/torch_dryrun_multigpu.py    # NCCL, a GPU per rank

The mesh is (2, N/2) for an even N >= 4, else (1, N). The scene: 64 splats
(SH 1) at 32x32, two cameras per data row, random targets. Checks: finite
losses and poses and no dropped record for both compositors; their losses
within 2e-2 at K=32 < n (per-bucket K truncation keeps more entries than
per-tile), and within 1e-5 at the untruncated config (K=64,
transmittance_min=0), where the depth-sharded fold is exact. Rank 0 prints
the losses; the exit code is non-zero when a check fails.
"""

from __future__ import annotations

import math
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gaussiansplattingregistration_tpu_torch.models.camera import Camera  # noqa: E402
from gaussiansplattingregistration_tpu_torch.models.gaussian_cloud import GaussianCloud  # noqa: E402
from gaussiansplattingregistration_tpu_torch.ops import math3d  # noqa: E402
from gaussiansplattingregistration_tpu_torch.ops.rasterize import RasterizeConfig  # noqa: E402
from gaussiansplattingregistration_tpu_torch.parallel import distributed  # noqa: E402
from gaussiansplattingregistration_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from gaussiansplattingregistration_tpu_torch.parallel.train_step import (  # noqa: E402
    make_photometric_train_step,
    shard_splats,
)


def make_scene(device, n=64, sh_degree=1, seed=0) -> GaussianCloud:
    """`__graft_entry__._make_scene`'s draws."""
    rng = np.random.default_rng(seed)
    k_rest = (sh_degree + 1) ** 2 - 1
    return GaussianCloud.create(
        xyz=rng.uniform(-1, 1, size=(n, 3)).astype(np.float32),
        features_dc=(rng.normal(size=(n, 1, 3)) * 0.3).astype(np.float32),
        features_rest=np.zeros((n, k_rest, 3), np.float32),
        opacity=np.full((n, 1), 1.0, np.float32),
        scaling=np.log(rng.uniform(0.05, 0.15, size=(n, 3))).astype(np.float32),
        rotation=rng.normal(size=(n, 4)).astype(np.float32),
        sh_degree=sh_degree, device=device,
    )


def make_camera(device, width, height, z=4.0, yaw=0.0) -> Camera:
    """`__graft_entry__._make_camera`: yawed about +y, 60 degrees."""
    f = width / (2 * math.tan(math.radians(60) / 2))
    R = math3d.axis_angle_to_rotmat(torch.tensor([0.0, 1.0, 0.0]), torch.tensor(yaw))
    return Camera.create(R, [0.0, 0.0, z], f, f, width, height, device=device)


def dryrun(device, init_method=None) -> None:
    """Every rank: join the group, run both compositors at both configs."""
    distributed.initialize(device=device, init_method=init_method)
    try:
        n = distributed.world_size()
        data = 2 if (n >= 4 and n % 2 == 0) else 1
        mesh = make_mesh(data=data)
        width = height = 32
        cloud = make_scene(device)
        n_cams = 2 * data
        cams = [make_camera(device, width, height, yaw=0.2 * i) for i in range(n_cams)]
        viewmats = torch.stack([c.viewmat for c in cams])
        intrinsics = torch.stack([c.intrinsics for c in cams])
        raw_targets = np.random.default_rng(0).uniform(0, 1, size=(n_cams, height, width, 3))
        splats = shard_splats(cloud, mesh, device=device)

        def losses(config):
            out = {}
            for comp in ("all_gather", "depth_sharded"):
                step, init, pad_targets = make_photometric_train_step(
                    mesh, width, height, cloud.sh_degree, config, compositor=comp,
                    device=device)
                xi, opt = init()
                xi, opt, loss, dropped = step(xi, opt, splats, viewmats, intrinsics,
                                              pad_targets(raw_targets.astype(np.float32)))
                loss = float(loss)
                if not (math.isfinite(loss) and bool(torch.isfinite(xi).all())):
                    raise AssertionError(f"{comp}: loss {loss}, xi {xi.tolist()}")
                if int(dropped) != 0:
                    raise AssertionError(f"{comp}: dropped {int(dropped)} records")
                out[comp] = (loss, float(torch.linalg.norm(xi.detach())))
            return out

        truncated = losses(RasterizeConfig(max_tiles_per_splat=9, max_splats_per_tile=32,
                                           tile_chunk=1))
        gap_k = abs(truncated["all_gather"][0] - truncated["depth_sharded"][0])
        if not gap_k < 2e-2:
            raise AssertionError(f"K=32 loss gap {gap_k}: {truncated}")
        exact = losses(RasterizeConfig(max_tiles_per_splat=9, max_splats_per_tile=64,
                                       tile_chunk=1, transmittance_min=0.0))
        gap = abs(exact["all_gather"][0] - exact["depth_sharded"][0])
        if not gap < 1e-5:
            raise AssertionError(f"untruncated loss gap {gap}: {exact}")
        if distributed.is_primary():
            print(f"dryrun_multigpu OK: mesh=({data}x{n // data}) "
                  + " ".join(f"{c}: loss={v[0]:.6f} |xi|={v[1]:.2e}"
                             for c, v in truncated.items())
                  + f" exact-config gap={gap:.2e}", flush=True)
    finally:
        distributed.shutdown()


def spawn(n: int) -> int:
    """Run `dryrun` on n gloo ranks of this machine's CPU, each a process
    of this script with torchrun's variables and a file rendezvous."""
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for rank in range(n):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank),
                       OMP_NUM_THREADS="1")
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank-of",
                 "file://" + os.path.join(tmp, "store")], env=env))
        return max(p.wait() for p in procs)


def main(argv) -> int:
    if len(argv) > 2 and argv[1] == "--rank-of":
        dryrun("cpu", init_method=argv[2])
        return 0
    if "RANK" in os.environ:          # under torchrun: one GPU per rank
        dryrun("cuda")
        return 0
    return spawn(int(argv[1]) if len(argv) > 1 else 4)


if __name__ == "__main__":
    sys.exit(main(sys.argv))
