"""On-card smoke check of the PyTorch/CUDA port.

Builds every CUDA kernel of the port from the checkout, holds each against
its plain-torch twin on the card, drives the port's main path (the forward
render of the bench scene, 1M splats at 1280x720, and the `render` CLI) and
prints one JSON line per phase. The last lines are the `kernels` record, the
card's name and power limit, and `{"ok": true, "device": {...}}`.

    python3 chip_smoke.py        # from the repo root, on a machine with one GPU

Exits non-zero, printing no result, without a CUDA device or without the
package beside it. Any failing phase raises.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
# H100 SXM published peaks (NVIDIA data sheet, dense): FP32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# Per live (pixel, entry) pair: ~20 FP32 operations and one exp (SFU),
# counted as 21 operations against the FP32 peak.
OPS_PER_PAIR = 21

# Bench scene and config (bench.py): 1M splats, SH degree 0, 1280x720, 70°.
WIDTH, HEIGHT, N_SPLATS = 1280, 720, 1_000_000


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of `fn` over `iters` back-to-back runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_errs(got, want):
    """Max abs error of (rgb, alpha, depth) and whether `live` is equal."""
    errs = [float((a - b).abs().max()) if a.numel() else 0.0
            for a, b in zip(got[:3], want[:3])]
    return errs, bool(torch.equal(got[3], want[3]))


def random_tiles(rng, counts, K: int, device):
    """Seeded [T, 10, K] tile params shaped like the gather's output: slots
    past counts[t] are zero. Every fourth tile holds large opaque splats so
    its pixels saturate within the first chunk."""
    T = len(counts)
    big = (np.arange(T) % 4 == 0)[:, None]
    var_x = np.where(big, rng.uniform(40, 200, (T, K)), rng.uniform(0.5, 30, (T, K)))
    var_y = np.where(big, rng.uniform(40, 200, (T, K)), rng.uniform(0.5, 30, (T, K)))
    cov_xy = rng.uniform(-0.7, 0.7, (T, K)) * np.sqrt(var_x * var_y)
    det = var_x * var_y - cov_xy ** 2
    g = np.stack([
        rng.uniform(-4, 20, (T, K)), rng.uniform(-4, 20, (T, K)),
        var_y / det, -cov_xy / det, var_x / det,
        np.where(big, rng.uniform(0.9, 0.99, (T, K)), rng.uniform(0.05, 0.95, (T, K))),
        rng.uniform(0, 1, (T, K)), rng.uniform(0, 1, (T, K)), rng.uniform(0, 1, (T, K)),
        rng.uniform(1, 5, (T, K)),
    ], axis=1)
    g *= (np.arange(K)[None, :] < np.asarray(counts)[:, None])[:, None, :]
    cnt = torch.tensor(counts, dtype=torch.float32, device=device)[:, None]
    return torch.tensor(g, dtype=torch.float32, device=device), cnt


def check_png(path: str, width: int, height: int) -> None:
    """Signature, IHDR size and the IDAT payload length of an 8-bit RGB PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG")
    w, h, depth, ctype = struct.unpack(">IIBB", data[16:26])
    if (w, h, depth, ctype) != (width, height, 8, 2):
        raise AssertionError(f"{path}: IHDR {w}x{h} depth {depth} type {ctype}")
    pos, idat = 8, b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + length]
        pos += 12 + length
    if len(zlib.decompress(idat)) != h * (1 + 3 * w):
        raise AssertionError(f"{path}: IDAT payload has the wrong size")


def bench_scene(dev):
    """The bench scene (bench.py) on `dev`, drawn from numpy's
    default_rng(0) in bench.py's order: (rasterize_arrays arguments, config)."""
    from gaussiansplattingregistration_tpu_torch.models.camera import Camera
    from gaussiansplattingregistration_tpu_torch.ops import math3d
    from gaussiansplattingregistration_tpu_torch.ops.rasterize import RasterizeConfig

    rng = np.random.default_rng(0)
    n = N_SPLATS
    xyz = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    scales = rng.uniform(0.002, 0.006, size=(n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opacity = (1.0 / (1.0 + np.exp(-rng.normal(0.0, 1.0, size=n)))).astype(np.float32)
    features = (rng.normal(size=(n, 1, 3)) * 0.3).astype(np.float32)
    cov = math3d.covariance_from_scaling_rotation(
        torch.as_tensor(scales, device=dev), torch.as_tensor(quats, device=dev))
    f = WIDTH / (2 * math.tan(math.radians(70) / 2))
    cam = Camera.create(np.eye(3), [0.0, 0.0, 3.0], f, f, WIDTH, HEIGHT, device=dev)
    args = (torch.as_tensor(xyz, device=dev), cov, torch.as_tensor(opacity, device=dev),
            torch.as_tensor(features, device=dev), cam.viewmat, cam.intrinsics,
            WIDTH, HEIGHT, 0, torch.zeros(3, device=dev))
    cfg = RasterizeConfig(max_tiles_per_splat=4, max_splats_per_tile=384,
                          tile_chunk=32, max_live_tiles=2688, backend="cuda")
    return args, cfg


def kernel_inputs(args, cfg):
    """The composite kernel's inputs for the frame of `args`, built as
    rasterize_tile_slab builds them, with the stage intermediates."""
    from gaussiansplattingregistration_tpu_torch.ops import rasterize as R

    means, cov, op, feats, viewmat, intr, W, H, deg, _ = args
    ts = cfg.tile_size
    tiles_x, tiles_y = -(-W // ts), -(-H // ts)
    T_live = R._row_cap(cfg, tiles_x * tiles_y)
    cam_center = -(viewmat[:3, :3].T @ viewmat[:3, 3])
    proj = R.project_gaussians(means, cov, viewmat, intr, W, H, cfg)
    colors = R.compute_view_colors(feats, means, cam_center, deg)
    table, _, _, counts, order, _ = R._build_tile_table(
        proj["means2d"], proj["radius"], proj["depth"], proj["valid"],
        tiles_x, tiles_y, cfg)
    packed = torch.cat([proj["means2d"], proj["conic"], (op * proj["valid"])[:, None],
                        colors, proj["depth"][:, None]], dim=-1)
    gT = R.gather_entries(packed, table[:T_live], cfg.max_tiles_per_splat)
    rows = order[:T_live].long()
    gT[:, 0, :] -= ((rows % tiles_x) * ts).float()[:, None]
    gT[:, 1, :] -= ((rows // tiles_x) * ts).float()[:, None]
    return {"proj": proj, "cam_center": cam_center, "packed": packed, "table": table,
            "T_live": T_live, "tiles": (tiles_x, tiles_y), "gT": gT,
            "cnt": counts[:T_live, None].float()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from gaussiansplattingregistration_tpu_torch.ops import _build, raster_cuda
    from gaussiansplattingregistration_tpu_torch.ops import rasterize as R

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # 1. Card and toolchain.
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    emit({"phase": "card", "nvidia_smi": card, "device": kind,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "nvcc": nvcc.splitlines()[-1]})

    # 2. Build every kernel (one nvcc per source, in parallel).
    t0 = time.perf_counter()
    built = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "built": built,
          "ptxas": {k: [ln.strip() for ln in v.splitlines()
                        if "registers" in ln or "smem" in ln or "spill" in ln]
                    for k, v in _build.build_logs.items()}})

    # 3. Kernel vs twin on seeded tiles. Tolerances: rgb/alpha 1e-5 and
    # depth 1e-4 (depths reach 5); `live` exactly. The kernel keeps T as a
    # running product, the twin as exp(cumsum(log1p(-alpha))): they differ
    # by rounding only.
    cfg = R.RasterizeConfig()
    rng = np.random.default_rng(0)
    for K, fixed in ((384, [0, 1, 127, 128, 129, 384]), (64, [0, 1, 63, 64])):
        counts = fixed + list(rng.integers(0, K + 1, 64 - len(fixed)))
        gT, cnt = random_tiles(rng, counts, K, dev)
        got = raster_cuda.composite_tiles(gT, cnt, 16, cfg)
        torch.cuda.synchronize()
        want = raster_cuda.composite_tiles_reference(gT, cnt, 16, cfg)
        errs, live_eq = max_errs(got, want)
        emit({"phase": "kernel_vs_twin", "tiles": 64, "K": K,
              "max_abs_err": {"rgb": errs[0], "alpha": errs[1], "depth": errs[2]},
              "live_equal": live_eq})
        if not (errs[0] <= 1e-5 and errs[1] <= 1e-5 and errs[2] <= 1e-4 and live_eq):
            raise AssertionError(f"composite kernel disagrees with its twin at K={K}")

    # 4. The main path at full width: the bench scene through
    # rasterize_arrays_with_stats, then the same frame on backend="torch".
    t0 = time.perf_counter()
    args, cfg = bench_scene(dev)

    raster_cuda.composite_tiles.launches = 0
    rgb, alpha, depth, stats = R.rasterize_arrays_with_stats(*args, cfg)
    torch.cuda.synchronize()
    launches = {"composite_fwd": raster_cuda.composite_tiles.launches}
    stats = {k: (float(v) if v.is_floating_point() else int(v)) for k, v in stats.items()}
    finite = all(bool(torch.isfinite(x).all()) for x in (rgb, alpha, depth))
    tcfg = dataclasses.replace(cfg, backend="torch")
    rgb_t, _, _ = R.rasterize_arrays(*args, tcfg)
    err_torch = float((rgb - rgb_t).abs().max())
    emit({"phase": "render", "splats": N_SPLATS, "width": WIDTH, "height": HEIGHT,
          "stats": stats, "launches": launches, "finite": finite,
          "rgb_max_abs_err_vs_torch_backend": err_torch,
          "mean_alpha": float(alpha.mean()), "seconds": time.perf_counter() - t0})
    if not finite:
        raise AssertionError("render is not finite")
    if stats["live_tile_overflow"] != 0:
        raise AssertionError(f"live_tile_overflow = {stats['live_tile_overflow']}")
    if launches["composite_fwd"] < 1:
        raise AssertionError("the render did not launch the composite kernel")
    if not err_torch <= 1e-4:
        raise AssertionError(f"cuda vs torch backend rgb differs by {err_torch}")

    # The kernel's inputs for this frame, as rasterize_tile_slab builds them.
    ts = cfg.tile_size
    inputs = kernel_inputs(args, cfg)
    gT, cnt, T_live = inputs["gT"], inputs["cnt"], inputs["T_live"]
    num_tiles = inputs["tiles"][0] * inputs["tiles"][1]

    # Kernel vs twin at the main path's shapes. Tolerance: rgb/alpha 1e-4,
    # depth 4e-4. Besides rounding, a pixel whose transmittance lands within
    # rounding of transmittance_min (1e-4) keeps or drops one weight
    # alpha*T <= 1e-4 (times a color <= ~1, or a depth <= 4); across ~7e5
    # pixels a few such pixels are expected.
    got = raster_cuda.composite_tiles(gT, cnt, ts, cfg)
    torch.cuda.synchronize()
    want = raster_cuda.composite_tiles_reference(gT, cnt, ts, cfg)
    errs, live_eq = max_errs(got, want)
    emit({"phase": "kernel_vs_twin", "tiles": T_live, "K": cfg.max_splats_per_tile,
          "max_abs_err": {"rgb": errs[0], "alpha": errs[1], "depth": errs[2]},
          "live_equal": live_eq})
    if not (errs[0] <= 1e-4 and errs[1] <= 1e-4 and errs[2] <= 4e-4 and live_eq):
        raise AssertionError("composite kernel disagrees with its twin at bench scale")

    frame_ms = cuda_ms(lambda: R.rasterize_arrays(*args, cfg), iters=10)
    frame_torch_ms = cuda_ms(lambda: R.rasterize_arrays(*args, tcfg), iters=3, warmup=1)
    kernel_ms = cuda_ms(lambda: raster_cuda.composite_tiles(gT, cnt, ts, cfg), iters=20)
    plain_ms = cuda_ms(lambda: raster_cuda.composite_tiles_reference(gT, cnt, ts, cfg),
                       iters=3, warmup=1)
    # Least time for the kernel's work on these inputs: live (pixel, entry)
    # pairs from the stats' chunk-granular horizon, against reading gT and
    # counts once and writing [T, P, 5] once.
    pairs = stats["mean_live"] * num_tiles * ts * ts
    ops_ms = pairs * OPS_PER_PAIR / PEAK_FP32_FLOPS * 1e3
    nbytes = gT.numel() * 4 + cnt.numel() * 4 + T_live * ts * ts * 5 * 4
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    emit({"phase": "timing", "card": card, "frame_ms": frame_ms,
          "frame_mpx_per_s": WIDTH * HEIGHT / frame_ms / 1e3,
          "frame_torch_backend_ms": frame_torch_ms,
          "kernel_ms": kernel_ms, "kernel_mpx_per_s": WIDTH * HEIGHT / kernel_ms / 1e3,
          "plain_ms": plain_ms, "live_pairs": pairs, "ops_bound_ms": ops_ms,
          "bytes": nbytes, "bytes_bound_ms": bytes_ms})

    # 5. The CLI: the demo pair merged under the inverse of its committed
    # offset, rendered to PNG at the default 1280x720.
    with open(os.path.join(REPO, "tests", "data", "demo_transform.json")) as fh:
        T_fix = np.linalg.inv(np.asarray(json.load(fh)["T_offset"], np.float64))
    with tempfile.TemporaryDirectory() as tmp:
        out_png = os.path.join(tmp, "merged.png")
        proc = subprocess.run(
            [sys.executable, "-m", "gaussiansplattingregistration_tpu_torch.cli",
             "render", os.path.join(REPO, "tests", "data", "demo_source.ply"), out_png,
             "--second", os.path.join(REPO, "tests", "data", "demo_target.ply"),
             "--transform", " ".join(repr(float(v)) for v in T_fix.reshape(-1))],
            cwd=REPO, capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            raise AssertionError(f"cli render failed (rc {proc.returncode}):\n{proc.stderr[-3000:]}")
        cli_out = json.loads(proc.stdout.strip().splitlines()[-1])
        check_png(out_png, WIDTH, HEIGHT)
    emit({"phase": "cli", "rc": proc.returncode, "result": cli_out})
    if not cli_out["mean_alpha"] > 0:
        raise AssertionError("cli render is empty")

    # 6. Every ported kernel, its launches on the main path and its numbers.
    emit({"kernels": [{
        "name": "composite_fwd",
        "route": "cuda",
        "source": "gaussiansplattingregistration_tpu_torch/csrc/composite_fwd.cu",
        "replaces": "gaussiansplattingregistration_tpu/ops/raster_pallas.py:173",
        "launches": launches["composite_fwd"],
        "max_abs_err": max(errs),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
