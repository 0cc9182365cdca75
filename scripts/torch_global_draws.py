"""How global registration's outcome depends on the random draw.

Runs the port's RANSAC (bench.py config 2: 50k points, voxel 0.05,
edge-length 0.9 and distance 0.075 checkers, 100000 hypotheses at most,
confidence 0.999), optionally followed by colored-ICP refinement at 0.1 for
30 iterations, and FGR, over a range of seeds, and prints each pose's
(rotation rad, translation) error against the truth; then FGR on
tests/data/golden_global.npz over the same seeds. With `--jax`, the JAX
package's FGR on the golden pair too (CPU).

    python3 scripts/torch_global_draws.py --device cuda --seeds 16 --refine
    python3 scripts/torch_global_draws.py --device cpu --seeds 12 --jax

One JSON line per sweep; `in_basin` counts poses within tests/test_goldens.py's
basin (rotation < 0.15 rad, translation < 2.5 voxels).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import port_scenes as scenes  # noqa: E402
from gaussiansplattingregistration_tpu_torch.models import parameters as P  # noqa: E402
from gaussiansplattingregistration_tpu_torch.models.point_cloud import PointCloud  # noqa: E402
from gaussiansplattingregistration_tpu_torch.ops import global_registration as gr  # noqa: E402
from gaussiansplattingregistration_tpu_torch.ops import icp  # noqa: E402


def sweep(name, errors, voxel):
    ok = [ang < 0.15 and trn < 2.5 * voxel for ang, trn in errors]
    print(json.dumps({"sweep": name, "in_basin": sum(ok), "seeds": len(ok),
                      "pose_err": errors}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seeds", type=int, default=16)
    ap.add_argument("--refine", action="store_true")
    ap.add_argument("--jax", action="store_true")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)

    src, tgt, col, T_src = scenes.global_draws(50_000)
    truth = np.linalg.inv(T_src)
    S, T = scenes.point_cloud(src, col, dev), scenes.point_cloud(tgt, col, dev)
    ransac = P.RANSACRegistrationParams(
        voxel_size=0.05, max_iteration=100_000, confidence=0.999,
        checkers=(P.CorrespondenceChecker("edge_length", 0.9),
                  P.CorrespondenceChecker("distance", 0.075)))
    refine = P.LocalRegistrationParams(registration_type=P.LocalRegistrationType.ICP_COLOR,
                                       max_correspondence=0.1, max_iteration=30)
    found, refined = [], []
    for seed in range(args.seeds):
        g = gr.ransac_registration(S, T, ransac, seed=seed)
        found.append(scenes.pose_err_parts(g.transformation, truth))
        if args.refine:
            r = icp.icp(S, T, refine, init_transform=g.transformation)
            refined.append(scenes.pose_err_parts(r.transformation, truth))
    sweep(f"config2_ransac_{args.device}", found, 0.05)
    if args.refine:
        sweep(f"config2_ransac_refined_{args.device}", refined, 0.05)
    sweep(f"config2_fgr_{args.device}", [
        scenes.pose_err_parts(gr.fgr_registration(S, T, P.FGRRegistrationParams(voxel_size=0.05),
                                              seed=seed).transformation, truth)
        for seed in range(args.seeds)], 0.05)

    g = np.load(os.path.join(REPO, "tests", "data", "golden_global.npz"))
    vox = float(g["voxel_size"])
    gs = PointCloud(points=torch.tensor(g["source"], dtype=torch.float32, device=dev))
    gt = PointCloud(points=torch.tensor(g["target"], dtype=torch.float32, device=dev))
    sweep(f"golden_fgr_{args.device}", [
        scenes.pose_err_parts(gr.fgr_registration(gs, gt, P.FGRRegistrationParams(voxel_size=vox),
                                              seed=seed).transformation, g["T_true"])
        for seed in range(args.seeds)], vox)
    if args.jax:
        import jax

        jax.config.update("jax_platforms", "cpu")
        import jax.numpy as jnp

        from gaussiansplattingregistration_tpu.models import parameters as JP
        from gaussiansplattingregistration_tpu.models.point_cloud import PointCloud as JPC
        from gaussiansplattingregistration_tpu.ops import global_registration as jgr

        js = JPC(points=jnp.asarray(g["source"], jnp.float32))
        jt = JPC(points=jnp.asarray(g["target"], jnp.float32))
        sweep("golden_fgr_jax_cpu", [
            scenes.pose_err_parts(jgr.fgr_registration(js, jt, JP.FGRRegistrationParams(
                voxel_size=vox), seed=seed).transformation, g["T_true"])
            for seed in range(args.seeds)], vox)
    return 0


if __name__ == "__main__":
    sys.exit(main())
