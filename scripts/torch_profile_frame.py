"""Where a frame's time goes on the card (PyTorch/CUDA port).

Times each stage of `rasterize_arrays(backend="cuda")` on the bench scene
(chip_smoke.bench_scene: 1M splats, 1280x720) with CUDA events, then traces
a few frames with torch.profiler, forward alone and forward + backward
(`torch.autograd.grad` of sum(rgb) w.r.t. means, cov, opacity, features),
and prints the top kernels by device time and the device's busy share of
the host wall time per frame. One JSON line per result; with a directory
argument the chrome traces are written there too.

    python3 scripts/torch_profile_frame.py [TRACE_DIR]   # from the repo root, one GPU
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import bench_scene, cuda_ms, kernel_inputs  # noqa: E402
from gaussiansplattingregistration_tpu_torch.ops import raster_cuda  # noqa: E402
from gaussiansplattingregistration_tpu_torch.ops import rasterize as R  # noqa: E402


def trace(frame, name: str, n_frames: int = 5) -> dict:
    """Host wall time per frame (ends in a synchronize), then a
    torch.profiler trace of `n_frames` frames: device time by kernel and
    the device's busy share of the wall time."""
    frame()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        frame()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 10

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n_frames):
            frame()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    if len(sys.argv) > 1:
        os.makedirs(sys.argv[1], exist_ok=True)
        prof.export_chrome_trace(os.path.join(sys.argv[1], f"torch_{name}_trace.json"))
    # Device-side events only (the kernels and copies themselves), so the
    # aten ops that launched them are not counted twice.
    rows = [(ev.self_device_time_total, ev.key, ev.count) for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]
    rows.sort(reverse=True)
    kernels_ms = sum(r[0] for r in rows) / 1e3 / n_frames
    return {
        "host_wall_ms_per_frame": wall_ms,
        "traced_ms_per_frame": traced_ms / n_frames,
        "device_kernel_ms_per_frame": kernels_ms,
        "device_busy_share": kernels_ms / wall_ms,
        "device_ops_per_frame": sum(r[2] for r in rows) / n_frames,
        "top_kernels_ms_per_frame": [
            {"kernel": key[:100], "ms": us / 1e3 / n_frames, "calls_per_frame": count / n_frames}
            for us, key, count in rows[:25]
        ],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_profile_frame: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    args, cfg = bench_scene(dev)
    means, cov, _, feats, viewmat, intr, W, H, deg, _ = args
    x = kernel_inputs(args, cfg)          # each stage's inputs, computed once
    proj, tiles_x, tiles_y = x["proj"], *x["tiles"]
    table, T_live, C = x["table"], x["T_live"], cfg.max_tiles_per_splat

    stages = {
        "project_gaussians": lambda: R.project_gaussians(means, cov, viewmat, intr, W, H, cfg),
        "compute_view_colors": lambda: R.compute_view_colors(feats, means, x["cam_center"], deg),
        "build_tile_table": lambda: R._build_tile_table(
            proj["means2d"], proj["radius"], proj["depth"], proj["valid"],
            tiles_x, tiles_y, cfg),
        "gather_entries": lambda: R.gather_entries(x["packed"], table[:T_live], C),
        "composite_fwd_kernel": lambda: raster_cuda.composite_tiles(
            x["gT"], x["cnt"], cfg.tile_size, cfg),
    }
    frame_ms = cuda_ms(lambda: R.rasterize_arrays(*args, cfg), iters=20, warmup=3)
    stage_ms = {name: cuda_ms(fn, iters=20, warmup=3) for name, fn in stages.items()}
    stage_ms["rest_of_frame"] = frame_ms - sum(stage_ms.values())
    print(json.dumps({"card": card, "frame_ms": frame_ms, "stage_ms": stage_ms}), flush=True)

    params = [a.detach().clone().requires_grad_(True) for a in args[:4]]

    def fwd_bwd():
        rgb = R.rasterize_arrays(*params, *args[4:], cfg)[0]
        return torch.autograd.grad(rgb.sum(), params)

    for name, frame in (("forward", lambda: R.rasterize_arrays(*args, cfg)),
                        ("forward_backward", fwd_bwd)):
        print(json.dumps({"card": card, "frame": name, **trace(frame, name)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
