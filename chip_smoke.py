"""On-card smoke check of the PyTorch/CUDA port.

Builds every CUDA kernel of the port from the checkout, then runs the card
tests that hold each kernel to its plain form (the composite kernels, their
footprint culling, the kNN kernel and the tile binning; `CARD_TESTS`, in a
pytest subprocess) and times the tile binning at the frames of the two
configurations that bin and of this script's main paths. Then it drives
the port's main paths at the bench scene's full width (1M splats at
1280x720): the forward render, the composite kernels against their twins
on the bench frame, the gradients of the whole rasterizer against the
plain-torch backend, fwd+bwd timing, and photometric pose refinement; then
the `render` and `photometric` CLI. Then the registration path at
bench.py's sizes (plain torch on the card, but the brute neighbor search,
which runs csrc/knn_brute.cu): neighbor search at 100k points against the
CPU and the kNN kernel's times at the registration cell's shapes, ICP
(config 1, brute and grid), HEM (config 3, 200k splats) and the mixture
multiscale registration on its levels, and tests/test_e2e_cli.py's flow
through the port's CLI, whose evaluation is driven once more in this
process with the kernels' launch counts. Then global registration (bench.py
config 2 and a 1M-point surface), plane fitting and merging, the viewer
serving the bench cloud (its frames and composite_fwd held against the
plain path on the viewer's own inputs), and their CLI. Then the multi-GPU
path: NCCL at world size 1 in this process on the bench cloud (sharded and
depth-sharded renders, the sharded train step of each compositor against
one device, with its time), two gloo ranks sharing the card in two
processes of this script (`--rank-worker`) on bench.py config 5's scene,
and `evaluate --sharded on` against `--sharded off`. Then bench_torch.py,
the port's benchmark runner, in a subprocess (its gates held, its five
metrics published), and both kernels against their twins on its config
5's frame. The scenes are port_scenes.py's. It prints one JSON line per
phase. The last lines are the `kernels` record (one entry per kernel and
main path), the card's name and power limit, and
`{"ok": true, "device": {...}}`.

    python3 chip_smoke.py        # from the repo root, on a machine with one GPU

Exits non-zero, printing no result, without a CUDA device or without the
package beside it. Any failing phase raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from port_scenes import (
    HEIGHT,
    N_SPLATS,
    WIDTH,
    bench_camera,
    bench_cloud,
    bench_config,
    bench_scene,
    card_line,
    check_bwd,
    check_png,
    config5_frame,
    config5_scene,
    demo_photometric_views,
    frame_args,
    global_draws,
    hem_cloud,
    icp_draws,
    kernel_inputs,
    knn_kernel_cases,
    load_json,
    max_errs,
    pair_counts,
    point_cloud,
    pose_err_parts,
    pose_error,
    random_cloud,
    sharded_step_camera,
    sqdist_rows,
    tile_bin_cells,
    two_clouds,
)
from splatbench.roofline.composite import OPS_TEST, OPS_VISIBLE_BWD, OPS_VISIBLE_FWD, peaks

REPO = os.path.dirname(os.path.abspath(__file__))
# H100 SXM published peaks (splatbench/roofline/peaks.json): FP32 outside
# the tensor cores, and HBM3 bandwidth. The bounds charge the compositor's
# whole formula (`OPS_*`, counted in splatbench/roofline/composite.py) to the
# visible pairs only: how many invisible pairs a kernel still tests depends
# on its design (the culled kernels test the `candidate` pairs). A bound
# that charges the test to every alive pair is still printed, as
# `alive_ops_bound_ms`.
H100 = peaks("NVIDIA H100 80GB HBM3")
PEAK_FP32_FLOPS = H100["fp32_flops"]
PEAK_BYTES_PER_S = H100["hbm_bytes_per_s"]
# The card tests that hold each kernel to its plain form, run first.
CARD_TESTS = ("tests/test_torch_tile_bin.py", "tests/test_torch_composite_kernels.py",
              "tests/test_torch_knn_kernel.py")

# Sizes of the registration phases: HEM's splats (bench.py config 3), the
# user-scale global registration surface, the 1M-point planar scene's planes
# and noise, and each plane of the merging scene (its noise a fifth of it).
HEM_SPLATS = 200_000
GLOBAL_LARGE_POINTS = 1_000_000
PLANE_POINTS, PLANE_NOISE = 450_000, 100_000
MERGE_PLANE_POINTS = 100_000


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


def kernel_device_ms(fn, kernel: str, iters: int = 20) -> float:
    """Mean device time of one launch of the CUDA kernel named `kernel`,
    from a torch.profiler trace of `iters` calls of `fn`: the kernel's own time,
    without the host's launch gaps, which a fast kernel's wrapper can
    exceed."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages()
           if ev.device_type == DeviceType.CUDA and kernel in ev.key]
    if len(evs) != 1 or not evs[0].count:
        raise AssertionError(f"{kernel}: {len(evs)} kernels of that name in the trace")
    # Per traced launch: a trace may drop a few of the `iters` launches.
    return evs[0].self_device_time_total / evs[0].count / 1e3


def fwd_bound(gT, cnt, out, ts: int, config) -> dict:
    """Least time for the forward kernel's work on (gT, cnt), whatever its
    design: the whole formula on this frame's visible pairs against reading
    the function's inputs once and writing its outputs once. The function
    reads only the entries before min(count, live) of each tile
    (`read_entries`; nothing past them changes an output) and the counts;
    it writes [T, P, 5] and live. `out` is the kernel's output on them."""
    pairs = pair_counts(gT, cnt, ts, config)
    ops_ms = pairs["visible"] * (OPS_TEST + OPS_VISIBLE_FWD) / PEAK_FP32_FLOPS * 1e3
    read_entries = int(torch.minimum(cnt[:, 0], out[3]).sum())
    entry_bytes = read_entries * gT.shape[1] * 4
    nbytes = entry_bytes + cnt.numel() * 4 + gT.shape[0] * (ts * ts * 5 + 1) * 4
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"pairs": pairs, "read_entries": read_entries, "entry_bytes": entry_bytes,
            "bytes": nbytes, "ops_bound_ms": ops_ms, "bytes_bound_ms": bytes_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def non_tie_mismatches(query, data, idx_a, idx_b) -> int:
    """Index mismatches whose two neighbors are not at the same distance."""
    q, d = query.cpu(), data.cpu()
    idx_a, idx_b = idx_a.cpu().reshape(len(q), -1), idx_b.cpu().reshape(len(q), -1)
    d_a, d_b = sqdist_rows(q, d, idx_a), sqdist_rows(q, d, idx_b)
    return int(((idx_a != idx_b) & (d_a != d_b)).sum())


# FP32 lane-instructions a second of one H100 SXM (67 TFLOP/s counts an FMA
# as two) and the instructions a (query, data) pair of the brute kNN sweep
# needs at least: 3 sub, 3 mul, 2 add, a compare and a select.
PEAK_FP32_INSTR = PEAK_FP32_FLOPS / 2
INSTR_PER_KNN_PAIR = 10


@contextlib.contextmanager
def brute_launches(rec: dict, extra: int = 0):
    """Counts the kNN kernel's launches over a block of registration-path
    work on the card (`knn_brute.launches` set to 0 before it, read after
    it) against the searches the block makes, with the program's spans
    on: one a HEM level's candidates (`hem.candidates`), one a normals pass
    (`normals.estimate`), one an ICP update and one more a run for its
    final metrics (`icp.iterations`, `icp.run`), and `extra` (other direct
    searches), less those that took the grid (`knn.grid_*`). Every brute
    search has to launch the kernel once: the launches equal both that
    count and the brute searches the public functions counted
    (`knn.knn`, `knn.hybrid`, `knn.nearest`), and are above 0. The block
    runs on the card only (a CPU search would count as a search and launch
    nothing). Fills `rec` with the counts."""
    from gaussiansplattingregistration_tpu_torch.ops import knn
    from gaussiansplattingregistration_tpu_torch.utils import profiling

    knn.knn_brute.launches = 0
    profiling.reset()
    with profiling.recording():
        yield rec
    torch.cuda.synchronize()
    snap = profiling.snapshot()
    profiling.reset()

    def n(name):
        return snap["spans"].get(name, {}).get("count", 0)

    rec.update({"launches": knn.knn_brute.launches,
                "hem_levels": n("hem.candidates"), "normals": n("normals.estimate"),
                "icp_updates": int(snap["counters"].get("icp.iterations", 0)),
                "icp_runs": n("icp.run"), "extra": extra,
                "grid_searches": n("knn.grid_nearest") + n("knn.grid_topk"),
                "brute_searches": n("knn.knn") + n("knn.hybrid") + n("knn.nearest")})
    rec["expected"] = (rec["hem_levels"] + rec["normals"] + rec["icp_updates"] + rec["icp_runs"]
                       + extra - rec["grid_searches"])
    if not 0 < rec["launches"] == rec["expected"] == rec["brute_searches"]:
        raise AssertionError(f"knn_brute launches on the registration path: {rec}")


def device_busy_ms(fn, iters: int = 5) -> float:
    """Device time of every kernel and copy of one call of `fn`, from a
    torch.profiler trace of `iters` calls (idle between them left out)."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(ev.self_device_time_total for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA) / iters / 1e3


TILE_BIN_FIELDS = ("cell", "splats", "valid", "entries", "slots", "kernel_ms",
                   "kernel_device_ms", "plain_ms", "bound_ms", "bound_share",
                   "entry_out_bytes")
# The `tile_bin` phase's frames (`tile_bin_cells`) each main path's
# `kernels` entry carries: the two cells' frames and its own.
TILE_BIN_PATH_CELLS = {"photometric": ("photo_pair_step_view", "splat1m_frame", "bench_config"),
                       "viewer": ("viewer_default",),
                       "sharded_train_step": ("sharded_step_camera1",),
                       "bench_config5": ("config5",)}


def tile_bin_shape(name, args, tiles_x, tiles_y, cfg) -> dict:
    """`tile_bin` (csrc/tile_bin.cu) on the card at one frame's table
    inputs `args` (its equality with the plain form there is a card test,
    tests/test_torch_tile_bin.py): the entries it emits over the N·C slots
    of the plain form; the kernel path's ms (events around a whole call,
    its one host read included), its device time (profiler), the plain
    form's ms and the bound: the least bytes the call must read and write
    at 3.35 TB/s (1 B a splat's flag, 16 B a valid splat's mean, radius
    and depth, the [T, K] int32 table, 8 B a tile of counts and order). The
    sorted entry ids it returns besides are `entry_out_bytes` (4 B an
    entry), outside the bound."""
    from gaussiansplattingregistration_tpu_torch.ops import rasterize as R

    timed = functools.partial(R._build_tile_table, *args, tiles_x, tiles_y, cfg)
    rec = {"cell": name, "splats": args[0].shape[0], "valid": int(args[3].sum()),
           "tiles": tiles_x * tiles_y, "C": cfg.max_tiles_per_splat,
           "K": cfg.max_splats_per_tile, "entries": timed()[1].numel(),
           "slots": args[0].shape[0] * cfg.max_tiles_per_splat}
    rec["entries_over_slots"] = rec["entries"] / rec["slots"]
    rec["kernel_ms"] = cuda_ms(timed, 10)
    rec["kernel_device_ms"] = device_busy_ms(timed)
    rec["plain_ms"] = cuda_ms(functools.partial(R._build_tile_table_plain, *args, tiles_x,
                                                tiles_y, cfg), 3, warmup=1)
    nbytes = (rec["splats"] + 16 * rec["valid"] + 4 * rec["tiles"] * rec["K"]
              + 8 * rec["tiles"])
    rec["bound_bytes"] = nbytes
    rec["bound_ms"] = 1e3 * nbytes / PEAK_BYTES_PER_S
    rec["bound_share"] = rec["bound_ms"] / rec["kernel_device_ms"]
    rec["entry_out_bytes"] = 4 * rec["entries"]
    return rec


def knn_kernel_times(dev) -> list:
    """`knn_brute` (csrc/knn_brute.cu) through the public functions at the
    timed cases of `knn_kernel_cases`, `reg200k_hem`'s shapes (its checks
    against the plain form are card tests, tests/test_torch_knn_kernel.py):
    the kernel's ms, the plain form's and the bound: 10 FP32
    instructions a (query, data) pair."""
    from gaussiansplattingregistration_tpu_torch.ops import knn

    out = []
    for name, q, d, k, timed in knn_kernel_cases(dev):
        if not timed:
            continue
        if k == 1:
            run = functools.partial(knn.nearest_neighbor, q, d)
            plain = functools.partial(knn._nearest_blocked, q, d, None)
        else:
            run = functools.partial(knn.knn, q, d, k)
            plain = functools.partial(knn._knn_blocked, q, d, k, None)
        rec = {"case": name, "Q": q.shape[0], "N": d.shape[0], "D": q.shape[1], "k": k}
        iters = 3 if q.shape[0] * d.shape[0] > 5e9 else 10
        rec["kernel_ms"] = cuda_ms(run, iters)
        rec["plain_ms"] = cuda_ms(plain, 2, warmup=1)
        rec["bound_ms"] = 1e3 * q.shape[0] * d.shape[0] * INSTR_PER_KNN_PAIR / PEAK_FP32_INSTR
        rec["bound_share"] = rec["bound_ms"] / rec["kernel_ms"]
        rec["gpairs_per_s"] = q.shape[0] * d.shape[0] / rec["kernel_ms"] / 1e6
        out.append(rec)
    return out


def card_tests_phase() -> dict:
    """The kernels' correctness checks: the card tests of `CARD_TESTS` in
    a pytest subprocess, their exit code and counts. Raises unless every
    card test ran and passed."""
    proc = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", *CARD_TESTS,
                           "-m", "card", "-q", "-p", "no:cacheprovider"],
                          cwd=REPO, capture_output=True, text=True, timeout=900)
    lines = proc.stdout.strip().splitlines()
    summary = lines[-1] if lines else ""
    counts = {key: int(n) for n, key in
              re.findall(r"(\d+) (passed|failed|skipped|deselected|errors?)", summary)}
    rec = {"rc": proc.returncode, "counts": counts, "summary": summary}
    if proc.returncode != 0 or set(counts) - {"passed", "deselected"} or not counts.get("passed"):
        raise AssertionError(f"card tests: {rec}\n{proc.stdout[-3000:]}\n{proc.stderr[-2000:]}")
    return rec


def knn_phase(dev, surf_src, surf_tgt, vol) -> dict:
    """Neighbor search at 100k points on the card against the CPU: nearest
    neighbor on a 10k-query subset and knn(k=32) on 2k queries of the
    surface pair; the grid against brute within the gate (0.05) on the
    volumetric scene. d2 within 1e-6 relative, no index mismatch but ties.
    Then the kernel's times at the registration cell's shapes
    (`knn_kernel_times`)."""
    from gaussiansplattingregistration_tpu_torch.ops import knn

    rec = {}
    q, d = torch.as_tensor(surf_src, device=dev), torch.as_tensor(surf_tgt, device=dev)
    t0 = time.perf_counter()
    d2, idx = knn.nearest_neighbor(q, d)
    torch.cuda.synchronize()
    rec["nn_100k_x_100k_s"] = time.perf_counter() - t0
    d2_cpu, idx_cpu = knn.nearest_neighbor(q[:10_000].cpu(), d.cpu())
    rec["nn_max_rel_d2_gap"] = float(((d2[:10_000].cpu() - d2_cpu).abs()
                                      / d2_cpu.clamp_min(1e-30)).max())
    rec["nn_non_tie_mismatches"] = non_tie_mismatches(q[:10_000], d, idx[:10_000], idx_cpu)
    rec["nn_ties"] = int((idx[:10_000].cpu() != idx_cpu).sum()) - rec["nn_non_tie_mismatches"]

    d2k, idxk = knn.knn(q[:2000], d, k=32)
    d2k_cpu, idxk_cpu = knn.knn(q[:2000].cpu(), d.cpu(), k=32)
    rec["knn32_max_rel_d2_gap"] = float(((d2k.cpu() - d2k_cpu).abs()
                                         / d2k_cpu.clamp_min(1e-30)).max())
    rec["knn32_non_tie_mismatches"] = non_tie_mismatches(q[:2000], d, idxk, idxk_cpu)

    gate = 0.05
    vq = torch.as_tensor(vol[1], device=dev)
    vd = torch.as_tensor(vol[0], device=dev)
    plan = knn.grid_nn_plan(vd, gate)
    if plan is None:
        raise AssertionError("no grid plan for the volumetric scene at gate 0.05")
    origin, inv_cell, dims, max_occ = plan
    table = knn.build_grid_table(vd, torch.ones(len(vd), dtype=torch.bool, device=dev),
                                 origin, inv_cell, *dims, max_occ)
    d2g, idxg = knn.grid_nearest_neighbor(vq, table, origin, inv_cell, *dims, 27 * max_occ)
    d2b, idxb = knn.nearest_neighbor(vq, vd)
    gated = d2b <= gate * gate
    rec.update({"grid_dims": list(dims), "grid_w": 27 * max_occ,
                "grid_gated_queries": int(gated.sum()),
                "grid_max_rel_d2_gap": float(((d2g - d2b).abs() / d2b.clamp_min(1e-30))[gated]
                                             .max()),
                "grid_non_tie_mismatches": non_tie_mismatches(vq[gated], vd, idxg[gated],
                                                              idxb[gated]),
                "grid_out_of_gate_ok": bool((d2g[~gated] > gate * gate).all())})
    bad = (rec["nn_max_rel_d2_gap"] > 1e-6 or rec["nn_non_tie_mismatches"]
           or rec["knn32_max_rel_d2_gap"] > 1e-6 or rec["knn32_non_tie_mismatches"]
           or rec["grid_max_rel_d2_gap"] > 1e-6 or rec["grid_non_tie_mismatches"]
           or not rec["grid_out_of_gate_ok"])
    if bad:
        raise AssertionError(f"neighbor search on the card disagrees: {rec}")
    rec["kernel"] = knn_kernel_times(dev)
    return rec


def icp_phase(dev, surf, vol) -> dict:
    """bench.py config 1 on the card: point-to-point ICP on two 100k
    surface clouds (gate 0.3, 30 fixed iterations; "auto" keeps brute),
    then the volumetric 100k pair at gate 0.05 ("auto" must take the grid).
    Wall per iteration after a warm-up run. Then the four variants at 10k
    points, card against CPU, poses within 1e-4. The card's runs count the
    kNN kernel's launches (`brute_launches`; their times are taken with
    the program's spans on)."""
    from gaussiansplattingregistration_tpu_torch.ops import icp

    rec = {"knn_brute": {}}
    src, tgt, col, _ = two_clouds(np.random.default_rng(4), 10_000, colors=True)
    variants = ("ICP_POINT_TO_POINT", "ICP_POINT_TO_PLANE", "ICP_COLOR", "ICP_GENERAL")
    on_card = {}
    # Colored ICP's color gradients and GICP's two covariance estimates are
    # searches of their own.
    with brute_launches(rec["knn_brute"], extra=3):
        _icp_100k(dev, surf, vol, rec)
        for variant in variants:
            on_card[variant] = icp.icp(point_cloud(src, col, dev), point_cloud(tgt, col, dev),
                                       _variant_params(variant))
    gaps = {}
    for variant in variants:
        on = [on_card[variant], icp.icp(point_cloud(src, col, "cpu"),
                                        point_cloud(tgt, col, "cpu"), _variant_params(variant))]
        gaps[variant] = {"pose_max_abs_gap": float(np.abs(on[0].transformation
                                                          - on[1].transformation).max()),
                         "fitness_gap": on[0].fitness - on[1].fitness,
                         "rmse_gap": on[0].inlier_rmse - on[1].inlier_rmse}
    rec["variants_10k_card_vs_cpu"] = gaps
    if not all(g["pose_max_abs_gap"] <= 1e-4 for g in gaps.values()):
        raise AssertionError(f"icp variants: card and CPU poses differ: {gaps}")
    return rec


def _variant_params(variant: str):
    from gaussiansplattingregistration_tpu_torch.models import parameters as P

    return P.LocalRegistrationParams(
        registration_type=P.LocalRegistrationType[variant], max_correspondence=0.3,
        max_iteration=10, relative_fitness=0.0, relative_rmse=0.0)


def _icp_100k(dev, surf, vol, rec) -> None:
    """`icp_phase`'s two 100k pairs, a warm-up run and a timed one each."""
    from gaussiansplattingregistration_tpu_torch.models import parameters as P
    from gaussiansplattingregistration_tpu_torch.ops import icp

    for name, (src, tgt, T_src), gate, want in (("surface_100k", surf, 0.3, "brute"),
                                                ("volumetric_100k", vol, 0.05, "grid")):
        source, target = point_cloud(src, dev=dev), point_cloud(tgt, dev=dev)
        params = P.LocalRegistrationParams(max_correspondence=gate, max_iteration=30,
                                           relative_fitness=0.0, relative_rmse=0.0)
        path = "grid" if icp.correspondence_plan(source, target, gate) is not None else "brute"
        icp.icp(source, target, params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = icp.icp(source, target, params)
        wall = time.perf_counter() - t0
        rec[name] = {"path": path, "iterations": res.num_iterations, "wall_s": wall,
                     "ms_per_iteration": wall / res.num_iterations * 1e3,
                     "fitness": res.fitness, "rmse": res.inlier_rmse,
                     "pose_error": pose_error(res.transformation, T_src)}
        if path != want:
            raise AssertionError(f"icp {name}: auto took {path}, expected {want}")
        rec[name]["pose_error_start"] = pose_error(np.eye(4), T_src)
        if not (res.num_iterations == 30 and np.isfinite(res.transformation).all()
                and rec[name]["pose_error"] < rec[name]["pose_error_start"]):
            raise AssertionError(f"icp {name}: {rec[name]}")


def hem_phase(dev):
    """bench.py config 3 on the card: 200k splats (SH degree 1, scales
    0.04-0.10), cluster_level=3, seed 0, twice (the second timed; the level
    sizes equal, each cut >= 1.8x); one level with injected parent flags at
    5k splats, card against CPU; the native backend's 200k pass, timed only.
    The card's work counts the kNN kernel's launches (`brute_launches`;
    its times are taken with the program's spans on). Returns (record,
    cloud, levels)."""
    from gaussiansplattingregistration_tpu_torch.models.parameters import GaussianMixtureParams
    from gaussiansplattingregistration_tpu_torch.ops import hem

    n = HEM_SPLATS
    cloud = hem_cloud(n, dev)
    params = GaussianMixtureParams(cluster_level=3)
    launches = {}
    # The level-0 search timed alone is a search of its own.
    with brute_launches(launches, extra=1):
        rec, levels, injected = _hem_on_card(dev, cloud, params)
    rec["knn_brute"] = launches

    # One level with injected flags, card against CPU (test_native_hem's
    # tolerances): the same alive count and rows.
    state, out = injected
    on_cpu = hem.MixtureState(**{f.name: getattr(state, f.name).to("cpu")
                                 for f in dataclasses.fields(state)})
    outs = [{f: getattr(o, f)[o.alive].cpu().numpy().astype(np.float64)
             for f in ("mean", "weight", "cov")}
            for o in (out, hem.hem_cluster_level(torch.Generator(device="cpu"), on_cpu,
                                                 3.0, 3.0, 2.5, 1.0))]
    order = [np.lexsort(np.round(o["mean"], 4).T[::-1]) for o in outs]
    rec["injected_5k"] = {"alive": [len(o["mean"]) for o in outs]}
    if len(outs[0]["mean"]) != len(outs[1]["mean"]):
        raise AssertionError(f"HEM level on the card and the CPU: {rec['injected_5k']}")
    for f, rtol, atol in (("mean", 1e-3, 1e-4), ("weight", 1e-3, 1e-4), ("cov", 5e-3, 1e-5)):
        a, b = outs[0][f][order[0]], outs[1][f][order[1]]
        rec["injected_5k"][f"{f}_max_abs_gap"] = float(np.abs(a - b).max())
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)

    t0 = time.perf_counter()
    native_levels = hem.create_mixture(cloud, params, seed=0, backend="native")
    rec["native_wall_s"] = time.perf_counter() - t0
    rec["native_level_sizes"] = [lvl.xyz.shape[0] for lvl in native_levels]
    return rec, cloud, levels


def _hem_on_card(dev, cloud, params):
    """`hem_phase`'s work on the card: (record, levels, (the injected
    level's state, the level made from it))."""
    from gaussiansplattingregistration_tpu_torch.ops import hem, knn

    n = cloud.num_points
    t0 = time.perf_counter()
    first, _ = hem.create_mixture(cloud, params, seed=0, with_stats=True)
    cold = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    levels, stats = hem.create_mixture(cloud, params, seed=0, with_stats=True)
    warm = time.perf_counter() - t0
    sizes = [lvl.xyz.shape[0] for lvl in levels]
    same_bits = all(np.array_equal(a.xyz, b.xyz) and np.array_equal(a.covariance, b.covariance)
                    for a, b in zip(first, levels))
    rec = {"splats": n, "level_sizes": sizes,
           "first_run_sizes": [lvl.xyz.shape[0] for lvl in first],
           "runs_bitwise_equal": same_bits, "stats": stats,
           "search": ["grid" if s["grid_search"] else "global" for s in stats],
           "cold_s": cold, "warm_s": warm}
    if rec["first_run_sizes"] != sizes:
        raise AssertionError(f"HEM level sizes differ between two runs: {rec}")
    prev = n
    for sz in sizes:
        if sz > prev / 1.8:
            raise AssertionError(f"HEM does not cut each level by 1.8x: {sizes}")
        prev = sz
    # Wall per level: warm runs of 1 and 2 levels against the 3-level run
    # (the same seed draws the same levels), and the level-0 global k=32
    # search alone (every parent against every point).
    walls = []
    for depth in (1, 2):
        t0 = time.perf_counter()
        hem.create_mixture(cloud, dataclasses.replace(params, cluster_level=depth), seed=0)
        walls.append(time.perf_counter() - t0)
    walls.append(warm)
    rec["level_wall_s"] = [walls[0], walls[1] - walls[0], walls[2] - walls[1]]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    parents = cloud.xyz[torch.rand(n, generator=gen, device=dev) < 1.0 / params.hem_reduction]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    knn.knn(parents, cloud.xyz, k=32)
    torch.cuda.synchronize()
    rec["level0_global_knn32_s"] = time.perf_counter() - t0
    rec["level0_parents"] = int(parents.shape[0])

    small = random_cloud(np.random.default_rng(5), 5000, 1, (0.04, 0.10), dev)
    state = hem.init_mixture(torch.Generator(device=dev), small.xyz, small.get_colors,
                             small.get_opacity[:, 0], small.get_covariance(),
                             small.features_rest.reshape(5000, -1), 3.0)
    flags = torch.as_tensor(np.random.default_rng(7).random(5000) < 1.0 / 3.0, device=dev)
    state = dataclasses.replace(state, is_parent=flags)
    out = hem.hem_cluster_level(torch.Generator(device=dev), state, 3.0, 3.0, 2.5, 1.0)
    return rec, levels, (state, out)


def multiscale_phase(dev, cloud, levels) -> dict:
    """bench.py's mixture registration on the HEM levels: the level pyramid
    of the 200k cloud against its copy moved by (0.05, -0.03, 0.02);
    voxel_values [0.3, 0.15, 0.08], iter_values [30, 20, 14]. A warm-up
    run, then the timed one (with the program's spans on, counting the kNN
    kernel's launches: `brute_launches`); the translation recovered within
    5e-3."""
    from gaussiansplattingregistration_tpu_torch.models.parameters import (
        MultiScaleRegistrationParams,
    )
    from gaussiansplattingregistration_tpu_torch.pipelines.multiscale import (
        multiscale_mixture_registration,
    )

    tgt_levels = [point_cloud(cloud.xyz, cloud.get_colors, dev)] + [
        point_cloud(lvl.xyz, lvl.colors, dev) for lvl in levels]
    T_off = np.eye(4, dtype=np.float32)
    T_off[:3, 3] = (0.05, -0.03, 0.02)
    src_levels = [pc.transform(T_off) for pc in tgt_levels]
    ms = MultiScaleRegistrationParams(voxel_values=[0.3, 0.15, 0.08], iter_values=[30, 20, 14])
    launches = {}
    with brute_launches(launches):
        multiscale_mixture_registration(src_levels, tgt_levels, ms)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = multiscale_mixture_registration(src_levels, tgt_levels, ms)
        wall = time.perf_counter() - t0
    err = float(np.abs(res.transformation[:3, 3] + T_off[:3, 3]).max())
    rec = {"level_points": [pc.num_points for pc in tgt_levels], "warm_s": wall,
           "knn_brute": launches,
           "fitness": res.fitness, "rmse": res.inlier_rmse,
           "translation_max_abs_err": err,
           "rotation_max_abs_err": float(np.abs(res.transformation[:3, :3] - np.eye(3)).max())}
    if not err < 5e-3:
        raise AssertionError(f"multiscale translation error {err} >= 5e-3: {rec}")
    return rec


def run_cli(*args) -> dict:
    """The port's CLI on the card; its last stdout line as JSON."""
    proc = subprocess.run(
        [sys.executable, "-m", "gaussiansplattingregistration_tpu_torch.cli", *map(str, args)],
        cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        raise AssertionError(f"cli {args[0]} failed (rc {proc.returncode}):\n"
                             f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def cli_e2e_phase(dev, raster_cuda, tmp) -> dict:
    """tests/test_e2e_cli.py's flow through the port's CLI on the card
    (register -> multiscale --use-mixture -> photometric -> evaluate ->
    merge -> render) on the demo pair, at its thresholds: every pose error
    < 2e-2, PSNR > 28, lpips not null, num_points == 2n. Then the same
    evaluation in this process, with the kernels' launch counts read."""
    from gaussiansplattingregistration_tpu_torch.pipelines.evaluation import (
        evaluate_registration,
        load_cameras_json,
    )
    from gaussiansplattingregistration_tpu_torch.utils import io as gio

    data = os.path.join(REPO, "tests", "data")
    src, tgt = os.path.join(data, "demo_source.ply"), os.path.join(data, "demo_target.ply")
    with open(os.path.join(data, "demo_transform.json")) as fh:
        truth = json.load(fh)
    T_off = np.asarray(truth["T_offset"], np.float64)
    t = {k: os.path.join(tmp, f"{k}.json") for k in ("t1", "t2", "t3")}

    def load(path):
        return load_json(path)["transformation"]

    t0 = time.perf_counter()
    walls = {}
    start = time.perf_counter()
    run_cli("register", src, tgt, "--method", "point_to_point", "--max-correspondence", "0.3",
            "--max-iteration", "30", "--output", t["t1"])
    walls["register"] = time.perf_counter() - start
    start = time.perf_counter()
    run_cli("multiscale", src, tgt, "--use-mixture", "--voxel-values", "0.3,0.1",
            "--iter-values", "15,10", "--init-transform", t["t1"], "--output", t["t2"])
    walls["multiscale"] = time.perf_counter() - start
    cams_json, _, _ = demo_photometric_views(tmp, 64, dev)
    start = time.perf_counter()
    run_cli("photometric", src, "--second", tgt, "--cameras", cams_json, "--images-path", tmp,
            "--init-transform", t["t2"], "--steps", "80", "--lr", "1e-3", "--output", t["t3"])
    walls["photometric"] = time.perf_counter() - start
    start = time.perf_counter()
    log = os.path.join(tmp, "eval.json")
    metrics = run_cli("evaluate", src, tgt, "--transform", t["t3"], "--cameras", cams_json,
                      "--images-path", tmp, "--log", log, "--sharded", "off")
    walls["evaluate"] = time.perf_counter() - start
    start = time.perf_counter()
    merged = os.path.join(tmp, "merged.ply")
    out = run_cli("merge", src, tgt, merged, "--transform", t["t3"])
    walls["merge"] = time.perf_counter() - start
    start = time.perf_counter()
    png = os.path.join(tmp, "render.png")
    run_cli("render", merged, png, "--width", "96", "--height", "96")
    walls["render"] = time.perf_counter() - start
    check_png(png, 96, 96)
    errs = [pose_error(load(t[k]), T_off) for k in ("t1", "t2", "t3")]
    rec = {"pose_errors": errs, "psnr": metrics["psnr"], "ssim": metrics["ssim"],
           "lpips": metrics["lpips"], "lpips_weights": metrics["lpips_weights"],
           "num_points": out["num_points"], "wall_s": time.perf_counter() - t0,
           "command_wall_s": walls}
    if not (all(e < 2e-2 for e in errs) and metrics["psnr"] > 28.0
            and metrics["lpips"] is not None and out["num_points"] == 2 * truth["n"]
            and load_json(log)["psnr"] == metrics["psnr"]):
        raise AssertionError(f"cli e2e flow: {rec}")

    # The slice's own path in this process: evaluate with launch counts.
    cams = load_cameras_json(cams_json, device=dev)
    first, second = (gio.load_gaussian_cloud(p, device=dev) for p in (src, tgt))
    reset_launches(raster_cuda)
    res = evaluate_registration(first, second, np.asarray(load(t["t3"])), cams, tmp,
                                device=dev)
    rec["evaluate_launches"] = read_launches(raster_cuda)
    rec["evaluate_psnr_in_process"] = res.psnr
    if rec["evaluate_launches"] != {"composite_fwd": len(cams), "composite_bwd": 0,
                                    "tile_bin": len(cams)}:
        raise AssertionError(f"evaluate launches {rec['evaluate_launches']}, "
                             f"expected one composite_fwd and one tile_bin per camera")
    if not abs(res.psnr - metrics["psnr"]) < 1e-4:
        raise AssertionError(f"evaluate in process {res.psnr} vs cli {metrics['psnr']}")
    return rec


def timed_s(fn):
    """(seconds, result) of fn() ending at a device sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def percent_fpfh(f) -> torch.Tensor:
    """Each 11-bin FPFH sub-histogram as percentages of its sum (f64)."""
    f = f.double().reshape(len(f), 3, 11)
    return (f / f.sum(-1, keepdim=True).clamp_min(1e-30) * 100.0).reshape(len(f), 33)


def feature_nn_mismatches(query, data, idx_a, idx_b) -> dict:
    """Rows where two feature-space nearest-neighbor searches disagree,
    split into near ties (the two candidates' f64 squared distances within
    1e-6 of |q|^2 + |d|^2, the Gram form's cancellation) and the rest."""
    q, d = query.double().cpu(), data.double().cpu()
    idx_a, idx_b = idx_a.cpu(), idx_b.cpu()
    rows = torch.nonzero(idx_a != idx_b)[:, 0]
    scale = 1e-6 * float((q * q).sum(1).max() + (d * d).sum(1).max())
    da = ((q[rows] - d[idx_a[rows]]) ** 2).sum(1)
    db = ((q[rows] - d[idx_b[rows]]) ** 2).sum(1)
    ties = int(((da - db).abs() <= scale).sum())
    return {"mismatches": int(rows.numel()), "near_ties": ties,
            "non_near_tie_mismatches": int(rows.numel()) - ties}


def global_case(dev, n: int, voxel: float, with_refine: bool) -> dict:
    """bench.py config 2 at n points (`two_clouds(rng(2), n, ...)`): FPFH +
    RANSAC (edge-length 0.9 and distance 1.5 voxel checkers, 100000
    hypotheses at most, confidence 0.999), then colored-ICP refinement at
    0.1 for 30 iterations; a warm-up run at seed 0, the timed run at seed 1,
    as bench.py. Then the flood run (16384 hypotheses, confidence 1.0) and
    FGR on the same pair. Returns the record, each cloud's preprocessing
    (downsampled cloud, FPFH) and the RANSAC parameters."""
    from gaussiansplattingregistration_tpu_torch.models import parameters as P
    from gaussiansplattingregistration_tpu_torch.ops import global_registration as gr
    from gaussiansplattingregistration_tpu_torch.ops import icp

    src, tgt, col, T_src = global_draws(n)
    truth = np.linalg.inv(T_src)
    source, target = point_cloud(src, col, dev), point_cloud(tgt, col, dev)
    ransac = P.RANSACRegistrationParams(
        voxel_size=voxel, max_iteration=100_000, confidence=0.999,
        checkers=(P.CorrespondenceChecker("edge_length", 0.9),
                  P.CorrespondenceChecker("distance", 1.5 * voxel)))
    refine = P.LocalRegistrationParams(registration_type=P.LocalRegistrationType.ICP_COLOR,
                                       max_correspondence=0.1, max_iteration=30)

    def run(seed):
        t_g, g = timed_s(lambda: gr.ransac_registration(source, target, ransac, seed=seed))
        t_r, r = timed_s(lambda: icp.icp(source, target, refine,
                                         init_transform=g.transformation)) \
            if with_refine else (0.0, None)
        return g, r, t_g, t_r

    cold, _ = timed_s(lambda: run(0))
    wall, (g, r, t_g, t_r) = timed_s(lambda: run(1))
    rec = {"points": n, "voxel": voxel, "cold_s": cold, "warm_s": wall, "ransac_s": t_g,
           "ransac_fitness": g.fitness, "ransac_rmse": g.inlier_rmse,
           "ransac_hypotheses": g.num_iterations,
           "ransac_pose_err": pose_err_parts(g.transformation, truth)}
    if with_refine:
        plan = icp.correspondence_plan(source, target, refine.max_correspondence)
        rec.update({"refine_s": t_r, "refine_path": "brute" if plan is None else "grid",
                    "refine_fitness": r.fitness,
                    "pose_err": pose_err_parts(r.transformation, truth)})
    pre, prepared = {}, {}
    for name, pc in (("source", source), ("target", target)):
        dt, prepared[name] = timed_s(lambda pc=pc: gr.preprocess_point_cloud(pc, voxel))
        pre[name] = {"ms": dt * 1e3, "downsampled": prepared[name][0].num_points}
    rec["preprocess"] = pre
    # bench.py's flood run: its confidence 1.0 is still reached once a
    # hypothesis scores fitness 1.0, so the search loop alone is also timed
    # over 16384 hypotheses with the exit disabled (confidence 2).
    flood = dataclasses.replace(ransac, max_iteration=16384, confidence=1.0)
    gr.ransac_registration(source, target, flood, seed=0)
    dt, gf = timed_s(lambda: gr.ransac_registration(source, target, flood, seed=1))
    (sd, sf), (td, tf) = prepared["source"], prepared["target"]
    corr = gr._feature_correspondences(sf, tf, False)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    def search():
        return gr._ransac_search(gen, sd.points, td.points, sd.normals, td.normals, *corr,
                                 ransac.max_correspondence, 2.0, 3, 512, 32,
                                 *gr._checker_spec(ransac))

    search()
    dt_search, (_, _, _, total) = timed_s(search)
    rec["flood"] = {"hypotheses": gf.num_iterations, "wall_s": dt,
                    "hypotheses_per_s": gf.num_iterations / dt,
                    "search_only_hypotheses": total, "search_only_s": dt_search,
                    "search_only_hypotheses_per_s": total / dt_search}
    fgr = P.FGRRegistrationParams(voxel_size=voxel)
    gr.fgr_registration(source, target, fgr, seed=0)
    dt, f = timed_s(lambda: gr.fgr_registration(source, target, fgr, seed=1))
    rec["fgr"] = {"warm_s": dt, "fitness": f.fitness, "rmse": f.inlier_rmse,
                  "pose_err": pose_err_parts(f.transformation, truth)}
    return rec, prepared, ransac


def global_phase(dev) -> dict:
    """Global registration on the card: bench.py config 2 (50k points, voxel
    0.05) with its refinement, the same surface at 1M points and voxel 0.02
    (no refinement: colored ICP at a 0.1 gate on 1M points is a brute
    1M x 1M sweep per iteration), then card against CPU on config 2's
    downsampled source: FPFH (percentage scale, 1e-4, bin-edge points
    excused and counted, at most 1% of points off by more), the feature
    correspondences (no mismatch but near
    ties) and one injected hypothesis batch (equal fitness vectors, the
    best T within 1e-4). Config 2's refined pose and FGR's must lie in the
    goldens' basin: rotation < 0.15 rad, translation < 2.5 voxels."""
    from gaussiansplattingregistration_tpu_torch.ops import features
    from gaussiansplattingregistration_tpu_torch.ops import global_registration as gr

    rec = {}
    rec["config2_50k"], prepared, ransac = global_case(dev, 50_000, 0.05, True)
    rec["surface_1m"], _, _ = global_case(dev, GLOBAL_LARGE_POINTS, 0.02, False)

    (down, fpfh), (tdown, tfpfh) = prepared["source"], prepared["target"]
    pts, nrm = down.points.cpu(), down.normals.cpu()
    want = features.compute_fpfh(pts, nrm, radius=0.25, max_nn=100)
    excused = features.near_bin_edge(pts, nrm, 0.25, 100)
    err = (percent_fpfh(fpfh.cpu()) - percent_fpfh(want)).abs().amax(dim=1)
    card_cpu = {"points": int(pts.shape[0]), "fpfh_excused_bin_edge_points": int(excused.sum()),
                "fpfh_points_over_1e-4": int((err > 1e-4).sum()),
                "fpfh_max_pct_err": float(err.max()),
                "fpfh_max_pct_err_not_excused": float(err[~excused].max()),
                "fpfh_failing_points": int(((err > 1e-4) & ~excused).sum())}
    idx_card = gr._feature_correspondences(fpfh, tfpfh, False)[0]
    idx_cpu = gr._feature_correspondences(fpfh.cpu(), tfpfh.cpu(), False)[0]
    card_cpu["correspondences"] = feature_nn_mismatches(fpfh, tfpfh, idx_card, idx_cpu)
    samples = np.random.default_rng(9).integers(0, down.num_points, (512, 3))
    outs = []
    for d in (dev, "cpu"):
        args = [a.to(d) for a in (down.points, tdown.points, down.normals, tdown.normals,
                                  idx_card, torch.ones(down.num_points, dtype=torch.bool))]
        outs.append(gr._eval_hypotheses(None, *args, 0.075, 3, 512, *gr._checker_spec(ransac),
                                        samples=samples))
    fit_card, fit_cpu = outs[0][0].cpu(), outs[1][0]
    best = int(torch.argmax(fit_card))
    card_cpu["injected_batch"] = {
        "fitness_equal": bool(torch.equal(fit_card, fit_cpu)),
        "passing_hypotheses": int((fit_cpu >= 0).sum()),
        "best_index_equal": best == int(torch.argmax(fit_cpu)),
        "best_T_max_abs_gap": float((outs[0][2][best].cpu() - outs[1][2][best]).abs().max())}
    rec["card_vs_cpu_config2"] = card_cpu

    c2 = rec["config2_50k"]
    basin = [("config2 refined", c2["pose_err"]), ("config2 FGR", c2["fgr"]["pose_err"])]
    for what, (ang, trn) in basin:
        if not (ang < 0.15 and trn < 2.5 * 0.05):
            raise AssertionError(f"{what} pose error {ang, trn} outside the basin: {rec}")
    inj = card_cpu["injected_batch"]
    if (card_cpu["fpfh_failing_points"] or card_cpu["fpfh_points_over_1e-4"] > 0.01 * len(err)
            or card_cpu["correspondences"]["non_near_tie_mismatches"]
            or not inj["fitness_equal"] or not inj["best_index_equal"]
            or not inj["best_T_max_abs_gap"] <= 1e-4):
        raise AssertionError(f"global registration on the card and the CPU disagree: {card_cpu}")
    return rec


def planar_scene(rng, n_plane: int, n_noise: int):
    """tests/test_planes.py's planar scene (its draws, in its order): two
    perpendicular patches, z ~ 0 and y ~ 1, and off-plane noise, as numpy
    (xyz, rgb, opacity logits, log-scales, quaternions), with the index
    ranges of the two planes."""
    a = np.column_stack([rng.uniform(-1, 1, (n_plane, 2)),
                         np.zeros(n_plane) + 0.003 * rng.normal(size=n_plane)])
    b = np.column_stack([rng.uniform(-1, 1, n_plane),
                         np.full(n_plane, 1.0) + 0.003 * rng.normal(size=n_plane),
                         rng.uniform(-1, 1, n_plane)])
    noise = rng.uniform(-1, 1, (n_noise, 3)) + np.array([0, 3.0, 0])
    xyz = np.vstack([a, b, noise]).astype(np.float32)
    n = xyz.shape[0]
    rgb = 0.5 + 0.3 * np.sin(3.0 * xyz)
    opacity = rng.normal(size=(n, 1)).astype(np.float32)
    scaling = np.log(rng.uniform(0.02, 0.05, size=(n, 3))).astype(np.float32)
    rotation = rng.normal(size=(n, 4)).astype(np.float32)
    return xyz, rgb, opacity, scaling, rotation, (np.arange(n_plane),
                                                 np.arange(n_plane, 2 * n_plane))


def planar_cloud(rng, n_plane, n_noise, dev):
    from gaussiansplattingregistration_tpu_torch.models.gaussian_cloud import GaussianCloud

    xyz, rgb, opacity, scaling, rotation, planes = planar_scene(rng, n_plane, n_noise)
    c0 = 0.28209479177387814
    cloud = GaussianCloud.create(xyz, ((rgb - 0.5) / c0)[:, None, :].astype(np.float32),
                                 np.zeros((len(xyz), 0, 3), np.float32), opacity, scaling,
                                 rotation, sh_degree=0, device=dev)
    return cloud, planes


def planes_phase(dev) -> dict:
    """Plane fitting and plane merging on the card: `fit_planes` on the
    planar scene at 1M points (two 450k planes, 100k noise; plane_count 2,
    300 iterations), given the scene's normals (estimating them would be a
    brute k=30 search over 1M points); card against CPU with injected
    samples at 20k points (estimated normals); `merge_plane_inliers` on a
    220k-point scene (2 x 100k + 20k, cluster_level 3), twice."""
    from gaussiansplattingregistration_tpu_torch.models.parameters import (
        GaussianMixtureParams,
        PlaneFittingParams,
    )
    from gaussiansplattingregistration_tpu_torch.models.point_cloud import PointCloud
    from gaussiansplattingregistration_tpu_torch.ops import normals as normals_ops
    from gaussiansplattingregistration_tpu_torch.ops import plane_fitting as pf
    from gaussiansplattingregistration_tpu_torch.pipelines import planes as planes_ops

    n_plane, n_noise, n_merge = PLANE_POINTS, PLANE_NOISE, MERGE_PLANE_POINTS
    params = PlaneFittingParams(plane_count=2, iterations=300, distance_threshold=0.02,
                                normal_threshold=0.8, min_distance=0.2)
    rng = np.random.default_rng(11)
    xyz, *_, (idx_a, idx_b) = planar_scene(rng, n_plane, n_noise)
    nrm = np.zeros_like(xyz)
    nrm[idx_a, 2] = 1.0
    nrm[idx_b, 1] = 1.0
    off = rng.normal(size=(n_noise, 3))
    nrm[2 * n_plane:] = off / np.linalg.norm(off, axis=1, keepdims=True)
    pc = PointCloud(points=torch.as_tensor(xyz, device=dev), normals=torch.as_tensor(
        nrm.astype(np.float32), device=dev))
    pf.fit_planes(pc, params, seed=0)
    wall, (coef, lists) = timed_s(lambda: pf.fit_planes(pc, params, seed=0))
    truth = {"z~0": (np.array([0, 0, 1.0]), idx_a), "y~1": (np.array([0, 1.0, 0]), idx_b)}
    found = {}
    for c, ix in zip(coef, lists):
        name = max(truth, key=lambda k: abs(float(np.dot(c[:3], truth[k][0]))))
        found[name] = {"inliers": int(len(ix)),
                       "true_plane_inliers": int(np.intersect1d(ix, truth[name][1]).size),
                       "normal_angle_rad": float(np.arccos(min(1.0, abs(float(
                           np.dot(c[:3], truth[name][0])))))), "plane": c.tolist()}
    rec = {"fit_1m": {"points": len(xyz), "warm_s": wall, "planes": found}}
    if sorted(found) != ["y~1", "z~0"] or any(
            f["true_plane_inliers"] < 0.95 * n_plane or f["normal_angle_rad"] > 0.05
            for f in found.values()):
        raise AssertionError(f"fit_planes at 1M points: {rec}")

    small, _ = planar_cloud(np.random.default_rng(12), 9_000, 2_000, dev)
    pts = small.xyz
    spc = PointCloud(points=pts, normals=normals_ops.estimate_normals(pts))
    draws = [np.random.default_rng(13 + p).integers(0, len(pts), (300, 3)) for p in range(2)]
    outs = [pf.fit_planes(PointCloud(points=spc.points.to(d), normals=spc.normals.to(d)),
                          params, samples=draws) for d in (dev, "cpu")]
    rec["injected_20k"] = {
        "planes": len(outs[0][0]),
        "plane_max_abs_gap": max(float(np.abs(a - b).max()) for a, b in zip(outs[0][0],
                                                                            outs[1][0])),
        "inlier_sets_equal": len(outs[0][1]) == len(outs[1][1]) and all(
            np.array_equal(a, b) for a, b in zip(outs[0][1], outs[1][1])),
        "inlier_counts": [len(ix) for ix in outs[0][1]]}
    if not (rec["injected_20k"]["planes"] == 2 and rec["injected_20k"]["inlier_sets_equal"]
            and rec["injected_20k"]["plane_max_abs_gap"] <= 1e-5):
        raise AssertionError(f"fit_planes on the card and the CPU: {rec['injected_20k']}")

    cloud, (ia, ib) = planar_cloud(np.random.default_rng(14), n_merge, n_merge // 5, dev)
    mparams = GaussianMixtureParams(cluster_level=3)
    first = planes_ops.merge_plane_inliers(cloud, [ia, ib], mparams, seed=0)
    wall, levels = timed_s(lambda: planes_ops.merge_plane_inliers(cloud, [ia, ib], mparams,
                                                                   seed=0))
    same = all(torch.equal(a.xyz, b.xyz) and torch.equal(a.covariance, b.covariance)
               for a, b in zip(first, levels))
    rec["merge_220k"] = {"points": cloud.num_points, "warm_s": wall,
                         "level_sizes": [c.num_points for c in levels],
                         "runs_equal": same}
    if not same or not all(n_merge // 5 < c.num_points < cloud.num_points for c in levels):
        raise AssertionError(f"merge_plane_inliers: {rec['merge_220k']}")
    return rec


def http_get(url: str):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def viewer_phase(dev, raster_cuda) -> tuple:
    """The viewer on the card: `serve` the 1M-splat bench cloud on port 0
    at 1280x720 (backend cuda, the viewer's default config: K = 256); fetch
    the page, the state and six frames (default view, yaw, pitch, roll,
    pan, zoom), each decoded; every frame not background, consecutive
    frames different, one composite_fwd launch per frame and no backward; a
    w=nan request answers 500 and the server answers after it. Then the
    default and the zoomed view against the plain path on the card: the
    frame against backend "torch" within 1e-4, and composite_fwd against
    its twin on that view's own kernel inputs at the bench shapes'
    tolerances (rgb/alpha 1e-4, depth 4e-4, live equal). Returns (record,
    the viewer's `kernels` entry for composite_fwd: its launches in the six
    frames, its error on the viewer's inputs, and its device time, plain
    time and bound on the default view's)."""
    from gaussiansplattingregistration_tpu_torch.pipelines import viewer
    from gaussiansplattingregistration_tpu_torch.utils.png import decode_png

    cloud = bench_cloud(dev)
    width, height = WIDTH, HEIGHT
    server, scene = viewer.serve(cloud, port=0, width=width, height=height, device=dev)
    try:
        base = "http://%s:%d" % server.server_address[:2]
        page = http_get(base + "/")
        state = http_get(base + "/state")
        views = ["", "yaw=0.6", "pitch=0.4", "roll=30", "panx=300&pany=-200", "zoom=-10"]
        http_get(base + "/render?w=256&h=256")           # warm-up, not counted
        reset_launches(raster_cuda)
        frames, ms = [], []
        for v in views:
            t0 = time.perf_counter()
            code, body = http_get(f"{base}/render?w={width}&h={height}&{v}")
            ms.append((time.perf_counter() - t0) * 1e3)
            if code != 200:
                raise AssertionError(f"viewer frame {v!r}: HTTP {code}: {body[:200]!r}")
            frames.append(decode_png(body).astype(np.int16))
        launches = read_launches(raster_cuda)
        bad_code, _ = http_get(base + "/render?w=nan&h=96")
        after_code, _ = http_get(base + "/render?w=128&h=96")
    finally:
        server.shutdown()
        server.server_close()
    # A request's parts: the default view's frame alone, and its PNG encode.
    from gaussiansplattingregistration_tpu_torch.ops.rasterize import rasterize
    from gaussiansplattingregistration_tpu_torch.utils.png import encode_png

    cam = scene.camera_for({}, width, height)
    render_ms = cuda_ms(lambda: rasterize(scene.cloud, cam, background=scene.background,
                                          config=scene.config, device=dev), iters=5) \
        if dev.type == "cuda" else None
    t0 = time.perf_counter()
    encode_png(frames[0].astype(np.uint8))
    encode_ms = (time.perf_counter() - t0) * 1e3

    cfg, ts = scene.config, scene.config.tile_size
    tcfg = dataclasses.replace(cfg, backend="torch")
    bg = torch.tensor(scene.background, device=dev)
    parity, entry = {}, {"launches": launches["composite_fwd"], "max_abs_err": 0.0}
    for name, q in (("default", {}), ("zoom", {"zoom": "-10"})):
        cam = scene.camera_for(q, width, height)
        rgb_cuda = rasterize(scene.cloud, cam, background=scene.background, config=cfg,
                             device=dev)[0]
        rgb_torch = rasterize(scene.cloud, cam, background=scene.background, config=tcfg,
                              device=dev)[0]
        c = scene.cloud
        inputs = kernel_inputs((c.xyz, c.get_covariance(), c.get_opacity[:, 0], c.get_features,
                                cam.viewmat, cam.intrinsics, width, height, c.sh_degree, bg),
                               cfg)
        gT, cnt = inputs["gT"], inputs["cnt"]
        got = raster_cuda.composite_tiles(gT, cnt, ts, cfg)
        torch.cuda.synchronize()
        want = raster_cuda.composite_tiles_reference(gT, cnt, ts, cfg)
        errs, live_eq = max_errs(got, want)
        parity[name] = {"frame_max_abs_err_vs_torch_backend": float(
                            (rgb_cuda - rgb_torch).abs().max()),
                        "tiles": int(gT.shape[0]), "K": int(gT.shape[2]),
                        "kernel_max_abs_err": {"rgb": errs[0], "alpha": errs[1],
                                               "depth": errs[2]},
                        "live_equal": live_eq}
        entry["max_abs_err"] = max(entry["max_abs_err"], *errs)
        if not (parity[name]["frame_max_abs_err_vs_torch_backend"] <= 1e-4 and errs[0] <= 1e-4
                and errs[1] <= 1e-4 and errs[2] <= 4e-4 and live_eq):
            raise AssertionError(f"viewer {name} view against the plain path: {parity[name]}")
        if name == "default" and dev.type == "cuda":
            fb = fwd_bound(gT, cnt, got, ts, cfg)
            entry.update({
                "ms": kernel_device_ms(lambda: raster_cuda.composite_tiles(gT, cnt, ts, cfg),
                                       "composite_fwd_kernel"),
                "plain_ms": cuda_ms(lambda: raster_cuda.composite_tiles_reference(
                    gT, cnt, ts, cfg), iters=3, warmup=1),
                "bound_ms": fb["bound_ms"], "bound_by": fb["bound_by"]})
            parity[name].update({"visible_pairs": fb["pairs"]["visible"],
                                 "read_entries": fb["read_entries"], "bytes": fb["bytes"]})
        del got, want, inputs, gT, cnt

    frames_bg = np.round(np.asarray(scene.background) * 255)
    rec = {"splats": cloud.num_points, "width": width, "height": height,
           "page_ok": page[0] == 200 and b"/render?" in page[1],
           "state": json.loads(state[1]), "ms_per_request": ms,
           "frame_render_ms": render_ms, "png_encode_ms": encode_ms,
           "non_background_share": [float((np.abs(f - frames_bg).max(-1) > 2).mean())
                                    for f in frames],
           "consecutive_mean_abs_diff": [float(np.abs(a - b).mean())
                                         for a, b in zip(frames, frames[1:])],
           "launches": launches, "nan_request_code": bad_code, "code_after_nan": after_code,
           "against_plain_path": parity, "kernel": entry}
    if not (rec["page_ok"] and rec["state"]["num_points"] == cloud.num_points
            and all(s > 0.05 for s in rec["non_background_share"])
            and all(d > 0.1 for d in rec["consecutive_mean_abs_diff"])
            and launches == {"composite_fwd": len(views), "composite_bwd": 0,
                             "tile_bin": len(views)}
            and bad_code == 500 and after_code == 200):
        raise AssertionError(f"viewer: {rec}")
    return rec, entry


def port_cli_in_process(dev, *args) -> dict:
    """The port's CLI in this process on `dev`; its last stdout line as
    JSON."""
    import contextlib
    import io

    from gaussiansplattingregistration_tpu_torch.cli.main import main as port_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        port_main([*map(str, args), "--device", torch.device(dev).type])
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def cli_global_planes_phase(dev, tmp) -> dict:
    """The new CLI subcommands on the card, in this process: `register
    --method ransac` and `--method fgr` on the demo pair, `fit-planes` on a
    planar pair (tests/test_planes.py's scene and offset), `register
    --plane-inliers-*` (and the mismatched-flag failure), `merge-planes`;
    then one `view` subprocess on port 0, one frame fetched, terminated."""
    from gaussiansplattingregistration_tpu_torch.ops import se3
    from gaussiansplattingregistration_tpu_torch.utils import io as gio
    from gaussiansplattingregistration_tpu_torch.utils.png import decode_png

    data = os.path.join(REPO, "tests", "data")
    src, tgt = os.path.join(data, "demo_source.ply"), os.path.join(data, "demo_target.ply")
    with open(os.path.join(data, "demo_transform.json")) as fh:
        T_off = np.asarray(json.load(fh)["T_offset"], np.float64)
    rec, walls = {}, {}
    for method, extra in (("ransac", ["--max-iteration", "20000"]), ("fgr", [])):
        t0 = time.perf_counter()
        out = port_cli_in_process(dev, "register", src, tgt, "--method", method, "--voxel-size",
                                  "0.1", "--checker-edge-length", "0.9", "--checker-distance",
                                  "0.15", "--max-correspondence", "0.15", "--mutual-filter",
                                  *extra)
        walls[method] = time.perf_counter() - t0
        T = np.asarray(out["transformation"])
        rec[method] = {"fitness": out["fitness"], "num_iterations": out["num_iterations"],
                       "pose_error": pose_error(T, T_off)}
        if not (set(out) == {"transformation", "fitness", "inlier_rmse", "num_iterations"}
                and np.isfinite(T).all()
                and np.abs(T[:3, :3] @ T[:3, :3].T - np.eye(3)).max() < 1e-4):
            raise AssertionError(f"cli register --method {method}: {out}")

    cloud, (ia, ib) = planar_cloud(np.random.default_rng(42), 500, 120, dev)
    T_gt = se3.se3_exp(torch.tensor([0.02, -0.015, 0.01, 0.03, -0.02, 0.015],
                                    dtype=torch.float64)).numpy()
    paths = {k: os.path.join(tmp, f"{k}.ply") for k in ("tgt", "src")}
    gio.save_gaussian_cloud(cloud, paths["tgt"])
    gio.save_gaussian_cloud(cloud.transform(np.linalg.inv(T_gt)), paths["src"])
    counts = {}
    t0 = time.perf_counter()
    for k in ("tgt", "src"):
        out = port_cli_in_process(dev, "fit-planes", paths[k], "--plane-count", 2,
                                  "--iterations", 300,
                                  "--distance-threshold", 0.02, "--normal-threshold", 0.8,
                                  "--min-distance", 0.2, "--output",
                                  os.path.join(tmp, f"planes_{k}.json"))
        counts[k] = out["inlier_counts"]
    walls["fit_planes_x2"] = time.perf_counter() - t0
    t_json = os.path.join(tmp, "t_planes.json")
    t0 = time.perf_counter()
    port_cli_in_process(dev, "register", paths["src"], paths["tgt"], "--method", "point_to_plane",
                        "--max-correspondence", "0.3", "--max-iteration", "40",
                        "--plane-inliers-first", os.path.join(tmp, "planes_src.json"),
                        "--plane-inliers-second", os.path.join(tmp, "planes_tgt.json"),
                        "--output", t_json)
    walls["register_plane_inliers"] = time.perf_counter() - t0
    err = pose_error(load_json(t_json)["transformation"], np.linalg.inv(T_gt))
    try:
        port_cli_in_process(dev, "register", paths["src"], paths["tgt"], "--plane-inliers-first",
                            os.path.join(tmp, "planes_src.json"))
        mismatch_fails = False
    except SystemExit:
        mismatch_fails = True
    t0 = time.perf_counter()
    merged = port_cli_in_process(dev, "merge-planes", paths["tgt"],
                                 os.path.join(tmp, "planes_tgt.json"),
                                 os.path.join(tmp, "merged"), "--cluster-level", 2)
    walls["merge_planes"] = time.perf_counter() - t0
    rec.update({"fit_planes_inlier_counts": counts, "plane_inlier_register_pose_error": err,
                "mismatched_plane_flags_fail": mismatch_fails,
                "merge_planes_levels": [lvl["points"] for lvl in merged["levels"]]})
    if not (all(len(c) == 2 and min(c) > 350 for c in counts.values()) and err < 2e-2
            and mismatch_fails and len(merged["levels"]) == 2):
        raise AssertionError(f"cli plane flow: {rec}")

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "gaussiansplattingregistration_tpu_torch.cli", "view", tgt,
         "--port", "0", "--device", torch.device(dev).type],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    code, frame = None, None
    try:
        line = proc.stdout.readline()
        if line.startswith("viewer: http://"):
            code, body = http_get(line.split()[1] + "render?w=96&h=80")
            walls["view_start_to_frame"] = time.perf_counter() - t0
            frame = decode_png(body) if code == 200 else None
    finally:
        proc.terminate()
        try:
            _, err_text = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err_text = proc.communicate()
    if not line.startswith("viewer: http://"):
        raise AssertionError(f"cli view printed {line!r}: {err_text[-2000:]}")
    rec["view_frame_shape"] = None if frame is None else list(frame.shape)
    rec["command_wall_s"] = walls
    if frame is None or frame.shape != (80, 96, 3) or not frame.std() > 1.0:
        raise AssertionError(f"cli view: HTTP {code}, {rec}")
    return rec


def bwd_bound(gT, cnt, fb, ts: int) -> dict:
    """Least time for the backward kernel's work on (gT, cnt): the whole
    backward formula on the forward's visible pairs (`fb` from `fwd_bound`)
    against reading the entries the forward reads, the counts and the
    cotangents once and writing the whole d_gT once. The forward outputs
    the kernel also reads are a residual of its design and not counted."""
    ops_ms = fb["pairs"]["visible"] * (OPS_TEST + OPS_VISIBLE_BWD) / PEAK_FP32_FLOPS * 1e3
    nbytes = fb["entry_bytes"] + cnt.numel() * 4 + gT.shape[0] * ts * ts * 5 * 4 + gT.numel() * 4
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"ops_bound_ms": ops_ms, "bytes": nbytes, "bytes_bound_ms": bytes_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def visibility_edges(gT, cnt, ts: int, config, tiles_per_step: int = 256) -> tuple:
    """Where the kernel and its twin may round a pair to opposite sides of
    the visibility test. Each side's sigma carries at most ~4 units of
    rounding (2^-24) of S = |a| dx^2 / 2 + |c| dy^2 / 2 + |b dx dy| (the
    kernel fuses multiply-adds, the twin does not), and exp and the product
    with the opacity a few more, so their alphas differ by less than
    gap = raw * eps32 * (8 S + 8), twice that sum. A pair is on the edge
    when the twin's alpha lies within gap of alpha_clip, or its sigma
    within eps32 * 8 S of 0. Returns (pixels [T, P]: an entry inside the
    tile's count is on the edge there; entries [T, K]: the entry is on the
    edge, or visible, at such a pixel, so its gradient may differ by the
    flipped pair's share)."""
    from gaussiansplattingregistration_tpu_torch.ops import raster_cuda as RC

    K, S = gT.shape[2], RC._CHUNK
    eps = float(torch.finfo(torch.float32).eps)
    px, py = RC._pixel_centres(ts, gT)
    pix_out, ent_out = [], []
    for t0 in range(0, gT.shape[0], tiles_per_step):
        g = gT[t0:t0 + tiles_per_step]
        _, in_count = RC._in_count(cnt[t0:t0 + tiles_per_step], g.shape[0], K, g.device)

        def chunk(c0):
            pc, inc = g[:, :, c0:c0 + S], in_count[:, c0:c0 + S]
            dx, dy, sigma, _, raw, alpha = RC._chunk_terms(pc, px, py, inc, config)
            size = (0.5 * (pc[:, None, 2, :].abs() * dx * dx + pc[:, None, 4, :].abs() * dy * dy)
                    + (pc[:, None, 3, :] * dx * dy).abs())
            gap = raw * eps * (8.0 * size + 8.0)
            edge = ((torch.clamp_max(raw, config.alpha_max) - config.alpha_clip).abs() <= gap) \
                | ((sigma.abs() <= eps * 8.0 * size) & (raw >= config.alpha_clip))
            return edge & inc[:, None, :], alpha > 0

        pixels = torch.zeros((g.shape[0], ts * ts), dtype=torch.bool, device=g.device)
        for c0 in range(0, K, S):
            pixels |= chunk(c0)[0].any(dim=-1)
        entries = torch.cat([((edge | vis) & pixels[:, :, None]).any(dim=1)
                             for edge, vis in (chunk(c0) for c0 in range(0, K, S))], dim=1)
        pix_out.append(pixels)
        ent_out.append(entries)
    return torch.cat(pix_out), torch.cat(ent_out)


def path_kernels(raster_cuda, args, cfg, seed: int) -> tuple:
    """Both kernels on the inputs of the frame `args`, a main path's own.
    composite_fwd against its twin at the bench shapes' tolerances (rgb
    and alpha 1e-4, depth 4e-4), except at pixels where the two put a pair
    on opposite sides of the visibility test (`visibility_edges`): each
    pixel past those tolerances must be one, and within the jump of one
    flipped pair (rgb and alpha 2 * alpha_clip * max(1, max |color|), depth
    that times the largest depth); live equal. composite_bwd against its
    twin by `check_bwd` on seeded cotangents, its error split between the
    entries those pixels touch and the rest. `max_abs_err` is over the
    whole frame; the flipped pixels' count and errors stand beside it.
    Each one's device time per launch, its twin's time and its bound.
    Returns (the `kernels` fields of composite_fwd, those of composite_bwd,
    the frame's tile and pair counts)."""
    ts = cfg.tile_size
    inputs = kernel_inputs(args, cfg)
    gT, cnt = inputs["gT"], inputs["cnt"]
    got = raster_cuda.composite_tiles(gT, cnt, ts, cfg)
    torch.cuda.synchronize()
    want = raster_cuda.composite_tiles_reference(gT, cnt, ts, cfg)
    edge, edge_entries = visibility_edges(gT, cnt, ts, cfg)
    diffs = [(got[0] - want[0]).abs().amax(dim=-1), (got[1] - want[1]).abs(),
             (got[2] - want[2]).abs()]
    flipped = (diffs[0] > 1e-4) | (diffs[1] > 1e-4) | (diffs[2] > 4e-4)
    flip_errs = [float(torch.where(flipped, d, 0.0).max()) for d in diffs]
    jump = 2.0 * cfg.alpha_clip * max(1.0, float(gT[:, 6:9].abs().max()))
    flip_tols = (jump, jump, jump * float(gT[:, 9].abs().max()))
    unexplained = int((flipped & ~edge).sum())
    live_eq = bool(torch.equal(got[3], want[3]))
    flips = {"edge_pixels": int(edge.sum()), "flipped_pixels": int(flipped.sum()),
             "flipped_max_abs_err": flip_errs,
             "other_max_abs_err": [float(torch.where(flipped, 0.0, d).max()) for d in diffs]}
    if not (unexplained == 0 and live_eq and all(e <= t for e, t in zip(flip_errs, flip_tols))):
        raise AssertionError(f"composite_fwd against its twin on a path's inputs: {flips}, "
                             f"{unexplained} past tolerance off the edge, flip bounds "
                             f"{flip_tols}, live equal {live_eq}")
    del want
    gen = np.random.default_rng(seed)
    T_live = gT.shape[0]
    cts = [torch.tensor(gen.normal(size=s), dtype=torch.float32, device=gT.device)
           for s in ((T_live, ts * ts, 3), (T_live, ts * ts), (T_live, ts * ts))]
    d_got = raster_cuda.composite_tiles_bwd(gT, cnt, *cts, ts, cfg, fwd_out=got)
    torch.cuda.synchronize()
    d_want = raster_cuda.composite_tiles_reference_bwd(gT, cnt, *cts, ts, cfg)
    bwd_rec = check_bwd(d_got, d_want, "a path's inputs")
    d_err = (d_got - d_want).abs().amax(dim=1)                         # [T, K]
    del d_got, d_want
    bwd_flips = {"edge_entries": int(edge_entries.sum()),
                 "edge_entries_max_abs_err": float(torch.where(edge_entries, d_err, 0.0).max()),
                 "other_entries_max_abs_err": float(torch.where(edge_entries, 0.0, d_err).max())}
    fb = fwd_bound(gT, cnt, got, ts, cfg)
    bb = bwd_bound(gT, cnt, fb, ts)
    fwd = {"max_abs_err": max(float(d.max()) for d in diffs), **flips,
           "ms": kernel_device_ms(lambda: raster_cuda.composite_tiles(gT, cnt, ts, cfg),
                                  "composite_fwd_kernel"),
           "plain_ms": cuda_ms(lambda: raster_cuda.composite_tiles_reference(gT, cnt, ts, cfg),
                               iters=3, warmup=1),
           "bound_ms": fb["bound_ms"], "bound_by": fb["bound_by"]}
    bwd = {"max_abs_err": max(bwd_rec["max_abs_err"]), **bwd_flips,
           "ms": kernel_device_ms(
               lambda: raster_cuda.composite_tiles_bwd(gT, cnt, *cts, ts, cfg, fwd_out=got),
               "composite_bwd_kernel"),
           "plain_ms": cuda_ms(
               lambda: raster_cuda.composite_tiles_reference_bwd(gT, cnt, *cts, ts, cfg),
               iters=3, warmup=1),
           "bound_ms": bb["bound_ms"], "bound_by": bb["bound_by"]}
    return fwd, bwd, {"tiles": int(T_live), "K": int(gT.shape[2]),
                            "read_entries": fb["read_entries"], **fb["pairs"]}


def mse_loss_grad(splats, views, width: int, height: int, sh_degree: int, config, xi) -> float:
    """The sharded train step's loss on one device: the squared error of
    clip(rgb) over each view's pixels and channels, summed, over C * H * W *
    3, through `rasterize_arrays`; one camera's graph at a time, its xi
    gradient accumulated into `xi.grad`. Returns the loss."""
    from gaussiansplattingregistration_tpu_torch.ops import math3d, se3
    from gaussiansplattingregistration_tpu_torch.ops.rasterize import rasterize_arrays

    norm = len(views) * height * width * 3.0
    total = torch.zeros((), device=xi.device)
    for viewmat, intrinsics, target in views:
        T = se3.se3_exp(xi)
        R = T[:3, :3]
        rgb = rasterize_arrays(splats["means"] @ R.T + T[:3, 3],
                               math3d.transform_covariance(splats["cov"], R),
                               splats["opacity"], splats["features"], viewmat, intrinsics,
                               width, height, sh_degree, torch.zeros(3, device=xi.device),
                               config, device=xi.device)[0]
        e = torch.sum((torch.clamp(rgb, 0.0, 1.0) - target) ** 2) / norm
        e.backward()
        total = total + e.detach()
    return float(total)


def step_parity(got, want) -> dict:
    """A sharded step's (loss, xi gradient, dropped) against one device's
    (loss, xi gradient): `ok` when the loss is within 1e-5 (relative), the
    gradient within 1e-3 of its scale and nothing was dropped."""
    (loss, grad, dropped), (want_loss, want_grad) = got, want
    rec = {"loss": loss, "single_loss": want_loss,
           "loss_rel_err": abs(loss - want_loss) / max(abs(want_loss), 1e-30),
           "grad": grad.tolist(), "single_grad": want_grad.tolist(),
           "grad_max_abs_err": float((grad - want_grad).abs().max()),
           "grad_scale": float(want_grad.abs().max()), "dropped": dropped}
    rec["ok"] = (rec["loss_rel_err"] <= 1e-5 and rec["grad_scale"] > 0
                 and rec["grad_max_abs_err"] <= 1e-3 * rec["grad_scale"] and dropped == 0)
    return rec


def train_views(cloud, cams, config, dev):
    """(viewmats [C, 4, 4], intrinsics [C, 3, 3], targets): each camera's
    clipped render of `cloud` moved by a twist of norm ~0.02."""
    from gaussiansplattingregistration_tpu_torch.ops import se3
    from gaussiansplattingregistration_tpu_torch.pipelines import photometric

    xi_true = torch.tensor([0.01, -0.008, 0.006, 0.008, -0.006, 0.01], device=dev)
    targets = photometric.render_targets(cloud.transform(se3.se3_exp(xi_true)), cams,
                                         config=config, device=dev)
    return (torch.stack([c.viewmat for c in cams]), torch.stack([c.intrinsics for c in cams]),
            torch.stack(targets))


def sharded_stepper(mesh, cloud, cams, views, config, compositor, dev):
    """`make_photometric_train_step` on this rank's shard of `cloud`, from
    xi = 0. Returns run() -> (loss, the step's xi gradient, dropped); each
    run takes one step."""
    from gaussiansplattingregistration_tpu_torch.parallel.train_step import (
        make_photometric_train_step,
        shard_splats,
    )

    step, init, pad_targets = make_photometric_train_step(
        mesh, cams[0].width, cams[0].height, cloud.sh_degree, config, compositor=compositor,
        device=dev)
    splats = shard_splats(cloud, mesh, device=dev)
    targets = pad_targets(views[2])
    state = list(init())

    def run():
        xi, opt, loss, dropped = step(*state, splats, views[0], views[1], targets)
        state[:] = [xi, opt]
        return float(loss), xi.grad.detach().clone(), int(dropped)

    return run


def single_stepper(cloud, cams, views, config, dev):
    """The sharded step's single-device counterpart on the whole cloud:
    `mse_loss_grad`, then Adam at lr 5e-3, from xi = 0. Returns run() ->
    (loss, the step's xi gradient)."""
    splats = {"means": cloud.xyz, "cov": cloud.covariance,
              "opacity": cloud.get_opacity[:, 0], "features": cloud.get_features}
    xi = torch.zeros(6, device=dev, requires_grad=True)
    opt = torch.optim.Adam([xi], lr=5e-3)

    def run():
        xi.grad = None
        loss = mse_loss_grad(splats, list(zip(*views)), cams[0].width, cams[0].height,
                             cloud.sh_degree, config, xi)
        opt.step()
        return loss, xi.grad.detach().clone()

    return run


def abs_errs(got, want) -> list:
    return [float((a - b).abs().max()) for a, b in zip(got, want)]


def parallel_world1_phase(dev, raster_cuda) -> tuple:
    """The multi-GPU path on NCCL at world size 1, in this process, at full
    width: the bench cloud (1M splats at 1280x720, bench config) through
    `rasterize_sharded` (within 1e-6 of `rasterize_arrays` on rgb, alpha and
    depth) and `rasterize_depth_sharded` (rgb and alpha 1e-5, depth 1e-4,
    nothing dropped), one composite_fwd each; one step of the sharded train
    step per compositor on two cameras from xi = 0, each with exactly 2
    composite_fwd and 2 composite_bwd launches and `step_parity` against
    the single-device step; then ms per step of each beside the
    single-device step on the same inputs, in turns. The group is made
    here and destroyed at the end. Returns (record, the `kernels` fields of
    composite_fwd and composite_bwd on the `sharded_train_step` path; its
    launches of each kernel are the record's `path_launches`)."""
    import torch.distributed as dist

    from gaussiansplattingregistration_tpu_torch.ops import rasterize as R
    from gaussiansplattingregistration_tpu_torch.parallel import distributed
    from gaussiansplattingregistration_tpu_torch.parallel.compositor import (
        rasterize_depth_sharded,
    )
    from gaussiansplattingregistration_tpu_torch.parallel.sharded_raster import rasterize_sharded

    if not distributed.initialize(device=dev):
        raise AssertionError("a process group was up before parallel_world1")
    try:
        mesh = distributed.global_mesh(data=1)
        cloud, cfg = bench_cloud(dev), bench_config()
        cams = [bench_camera(dev), sharded_step_camera(dev)]
        overflow = [int(R.rasterize_arrays_with_stats(*frame_args(cloud, c), cfg, device=dev)[3]
                        ["live_tile_overflow"]) for c in cams]
        single = R.rasterize_arrays(*frame_args(cloud, cams[0]), cfg, device=dev)
        reset_launches(raster_cuda)
        ag = rasterize_sharded(cloud, cams[0], mesh, config=cfg, device=dev)
        *ds, dropped = rasterize_depth_sharded(cloud, cams[0], mesh, config=cfg, device=dev)
        rec = {"backend": dist.get_backend(), "world": dist.get_world_size(),
               "splats": cloud.num_points, "width": WIDTH, "height": HEIGHT,
               "render_launches": read_launches(raster_cuda), "live_tile_overflow": overflow,
               "all_gather_max_abs_err": abs_errs(ag, single),
               "depth_sharded_max_abs_err": abs_errs(ds, single), "dropped": int(dropped)}
        e_ag, e_ds = rec["all_gather_max_abs_err"], rec["depth_sharded_max_abs_err"]
        if not (max(e_ag) <= 1e-6 and e_ds[0] <= 1e-5 and e_ds[1] <= 1e-5 and e_ds[2] <= 1e-4
                and rec["dropped"] == 0 and not any(overflow)
                and rec["render_launches"] == {"composite_fwd": 2, "composite_bwd": 0,
                                               "tile_bin": 2}):
            raise AssertionError(f"parallel_world1 renders: {rec}")
        del ag, ds, single

        views = train_views(cloud, cams, cfg, dev)
        runs = {"single": single_stepper(cloud, cams, views, cfg, dev)}
        want = runs["single"]()
        path_launches = {"composite_fwd": 0, "composite_bwd": 0, "tile_bin": 0}
        for comp in ("all_gather", "depth_sharded"):
            runs[comp] = sharded_stepper(mesh, cloud, cams, views, cfg, comp, dev)
            reset_launches(raster_cuda)
            got = runs[comp]()
            launches = read_launches(raster_cuda)
            rec[f"{comp}_step"] = {**step_parity(got, want), "launches": launches}
            if not (rec[f"{comp}_step"]["ok"]
                    and launches == {"composite_fwd": 2, "composite_bwd": 2, "tile_bin": 2}):
                raise AssertionError(f"parallel_world1 {comp} step: {rec[f'{comp}_step']}")
            path_launches = {k: v + launches[k] for k, v in path_launches.items()}
        turns = {k: [] for k in runs}
        for order in (list(runs), list(runs)[::-1]):
            for k in order:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(3):
                    runs[k]()
                torch.cuda.synchronize()
                turns[k].append((time.perf_counter() - t0) * 1e3 / 3)
        rec["ms_per_step"] = {k: sum(v) / len(v) for k, v in turns.items()}
        rec["ms_per_step_turns"] = turns
        fwd, bwd, rec["kernel_inputs"] = path_kernels(
            raster_cuda, frame_args(cloud, cams[1]), cfg, seed=3)
    finally:
        distributed.shutdown()
    rec["path_launches"] = path_launches
    fwd["launches"], bwd["launches"] = path_launches["composite_fwd"], \
        path_launches["composite_bwd"]
    return rec, fwd, bwd


def two_rank_worker(out_dir: str, dev) -> None:
    """One rank of `parallel_two_ranks_phase`: RANK, WORLD_SIZE = 2 and
    LOCAL_RANK = 0 (both ranks on the one card) from the environment,
    joined over gloo on a FileStore in `out_dir`. On config 5's scene over a
    (1 x 2) mesh: the all-gather render; the depth-sharded render at
    transmittance_min = 0 and a K at which the single render truncates no
    tile; one train step of each compositor on two cameras from xi = 0.
    Rank 0 then runs each on one device. Writes `rank<r>.json` with the
    numbers and this rank's launches."""
    import torch.distributed as dist

    from gaussiansplattingregistration_tpu_torch.ops import raster_cuda
    from gaussiansplattingregistration_tpu_torch.ops import rasterize as R
    from gaussiansplattingregistration_tpu_torch.parallel import collectives, distributed
    from gaussiansplattingregistration_tpu_torch.parallel.compositor import (
        rasterize_depth_sharded,
    )
    from gaussiansplattingregistration_tpu_torch.parallel.mesh import make_mesh
    from gaussiansplattingregistration_tpu_torch.parallel.sharded_raster import rasterize_sharded

    distributed.initialize(backend="gloo", device=dev,
                           init_method="file://" + os.path.join(out_dir, "store"))
    try:
        rank = dist.get_rank()
        mesh = make_mesh(data=1, splat=2)
        cloud, cams, cfg = config5_scene(dev)
        frame = frame_args(cloud, cams[0])
        max_run = int(R.rasterize_arrays_with_stats(*frame, cfg, device=dev)[3]["max_run"])
        k_exact = int(collectives.all_reduce(
            torch.tensor(max(256, -(-max_run // 32) * 32), device=dev), "max"))
        exact = dataclasses.replace(cfg, transmittance_min=0.0, max_splats_per_tile=k_exact,
                                    max_bwd_splats_per_tile=None)
        rec = {"rank": rank, "backend": dist.get_backend(), "mesh": [1, 2],
               "k_exact": k_exact, "launches": {}}
        reset_launches(raster_cuda)
        ag = rasterize_sharded(cloud, cams[0], mesh, config=cfg, device=dev)
        rec["launches"]["all_gather_render"] = read_launches(raster_cuda)
        reset_launches(raster_cuda)
        *ds, dropped = rasterize_depth_sharded(cloud, cams[0], mesh, config=exact, device=dev)
        rec["launches"]["depth_sharded_render"] = read_launches(raster_cuda)
        rec["dropped"] = int(dropped)
        views = train_views(cloud, cams, cfg, dev)
        steps = {}
        for comp, config in (("all_gather", cfg), ("depth_sharded", exact)):
            run = sharded_stepper(mesh, cloud, cams, views, config, comp, dev)
            reset_launches(raster_cuda)
            steps[comp] = run()
            rec["launches"][f"{comp}_step"] = read_launches(raster_cuda)
    finally:
        distributed.shutdown()
    if rank == 0:
        *single, stats = R.rasterize_arrays_with_stats(*frame, cfg, device=dev)
        *single_exact, stats_exact = R.rasterize_arrays_with_stats(*frame, exact, device=dev)
        rec.update({"single_overflow_tiles": int(stats["overflow_tiles"]),
                    "single_exact_overflow_tiles": int(stats_exact["overflow_tiles"]),
                    "all_gather_max_abs_err": abs_errs(ag, single),
                    "depth_sharded_max_abs_err": abs_errs(ds, single_exact)})
        for comp, config in (("all_gather", cfg), ("depth_sharded", exact)):
            rec[f"{comp}_step"] = step_parity(
                steps[comp], single_stepper(cloud, cams, views, config, dev)())
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(rec, fh)


def parallel_two_ranks_phase(tmp) -> dict:
    """Two processes on the one card over gloo (NCCL refuses two ranks on
    one GPU), `two_rank_worker`: each rank's slab and depth slice run
    through the CUDA kernels, and gloo copies every collective's CUDA
    tensors through host memory. Gates, against one device in rank 0's
    process: the all-gather render within 1e-5 (rgb, alpha) and 1e-4
    (depth); the depth-sharded render within the same with nothing
    dropped, where the single render truncates no tile; each compositor's
    (1 x 2) train step by `step_parity`; on each rank one composite_fwd
    per render and two of each kernel per step."""
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK="0")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank-worker", tmp], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {rank} failed (rc {p.returncode}):\n{err[-3000:]}")
    ranks = [load_json(os.path.join(tmp, f"rank{r}.json")) for r in range(2)]
    r0 = ranks[0]
    rec = {"collectives": "gloo; CUDA tensors copied through host memory by gloo",
           "ranks": [{k: r[k] for k in ("rank", "backend", "launches", "dropped")}
                     for r in ranks],
           **{k: r0[k] for k in ("k_exact", "single_overflow_tiles",
                                 "single_exact_overflow_tiles", "all_gather_max_abs_err",
                                 "depth_sharded_max_abs_err", "all_gather_step",
                                 "depth_sharded_step")}}
    render = {"composite_fwd": 1, "composite_bwd": 0, "tile_bin": 1}
    step = {"composite_fwd": 2, "composite_bwd": 2, "tile_bin": 2}
    ok_errs = [e <= tol for errs in (r0["all_gather_max_abs_err"],
                                     r0["depth_sharded_max_abs_err"])
               for e, tol in zip(errs, (1e-5, 1e-5, 1e-4))]
    if not (all(ok_errs) and r0["single_exact_overflow_tiles"] == 0
            and all(r["dropped"] == 0 and r["backend"] == "gloo" for r in ranks)
            and r0["all_gather_step"]["ok"] and r0["depth_sharded_step"]["ok"]
            and all(r["launches"] == {"all_gather_render": render, "depth_sharded_render": render,
                                      "all_gather_step": step, "depth_sharded_step": step}
                    for r in ranks)):
        raise AssertionError(f"parallel_two_ranks: {rec}")
    return rec


def cli_sharded_eval_phase(dev, raster_cuda, tmp) -> dict:
    """`evaluate --sharded on` (a world of one on NCCL, which the command
    makes and ends) against `--sharded off` on the demo pair's three views
    at 64x64, in this process: MSE, RMSE, PSNR and SSIM within 1e-5,
    `lpips` null, one composite_fwd per camera each, no group left up."""
    import torch.distributed as dist

    data = os.path.join(REPO, "tests", "data")
    cams_json, init_json, _ = demo_photometric_views(tmp, 64, dev)
    common = ("evaluate", os.path.join(data, "demo_source.ply"),
              os.path.join(data, "demo_target.ply"), "--transform", init_json,
              "--cameras", cams_json, "--images-path", tmp, "--no-lpips")
    out, launches = {}, {}
    for mode in ("on", "off"):
        reset_launches(raster_cuda)
        out[mode] = port_cli_in_process(dev, *common, "--sharded", mode)
        launches[mode] = read_launches(raster_cuda)
    keys = ("mse", "rmse", "psnr", "ssim")
    rec = {mode: {k: out[mode][k] for k in keys + ("lpips", "error_list")} for mode in out}
    rec.update({"abs_diff": {k: abs(out["on"][k] - out["off"][k]) for k in keys},
                "launches": launches, "group_left_up": dist.is_initialized()})
    if not (all(d <= 1e-5 for d in rec["abs_diff"].values()) and out["on"]["lpips"] is None
            and not rec["group_left_up"] and out["on"]["error_list"] == []
            and all(v == {"composite_fwd": 3, "composite_bwd": 0, "tile_bin": 3}
                    for v in launches.values())):
        raise AssertionError(f"cli_sharded_eval: {rec}")
    return rec


BENCH_HEADLINE = "rasterize_fwd_bwd_pixels_per_s_per_chip_1M_splats"
BENCH_SECONDARIES = ("icp_p2p_iters_per_s_100k_pts",
                     "global_fpfh_ransac_plus_colored_refine_wall_s_50k_pts",
                     "hem3_plus_multiscale_wall_s_200k_splats",
                     "photometric_pose_opt_steps_per_s_100k_splats_640x360")


def bench_phase(dev, raster_cuda, tmp) -> tuple:
    """bench_torch.py on the card, in a subprocess of at most 400 s: rc 0;
    the headline published by name with a value > 0, its uniform-scene
    truncation oracle >= 40 dB, no tile over the backward cap, no live tile
    past max_live_tiles, 32 + 32 kernel launches over the timed frames; the
    four secondaries by bench.py's names, none failed, config 5's timed
    steps 10 + 10 launches (and one tile_bin a frame and a step). Then
    both kernels on config 5's own frame (`path_kernels`; seed 5 for the
    cotangents). Returns (record, the `kernels` fields of composite_fwd,
    composite_bwd and tile_bin on that path, with config 5's launches from
    the subprocess)."""
    extra = os.path.join(tmp, "extra.json")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(REPO, "bench_torch.py"),
                           "--extra-out", extra],
                          cwd=REPO, capture_output=True, text=True, timeout=400)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"bench_torch.py failed (rc {proc.returncode}):\n"
                             f"{proc.stderr[-3000:]}")
    head = json.loads(proc.stdout.strip().splitlines()[-1])
    detail = head["detail"]
    secondary = {r["metric"]: r for r in load_json(extra)["secondary"]}
    photo = secondary.get(BENCH_SECONDARIES[3], {}).get("detail", {})
    rec = {"subprocess_seconds": seconds,
           "log": [ln for ln in proc.stderr.splitlines() if ln.startswith("# ")],
           "headline": head,
           "values": {BENCH_HEADLINE: head.get("value"),
                      **{m: secondary.get(m, {}).get("value") for m in BENCH_SECONDARIES}},
           "secondary": list(secondary.values())}
    steps = {"composite_fwd": 10, "composite_bwd": 10, "tile_bin": 10}
    failed = [r for r in secondary.values() if "error" in r]
    if not (head.get("metric") == BENCH_HEADLINE and head["value"] > 0
            and detail["truncation_psnr_db"] >= 40.0
            and detail["bwd_cap_violations"] == 0 and detail["live_tile_overflow"] == 0
            and detail["launches"] == {"composite_fwd": 32, "composite_bwd": 32, "tile_bin": 32}
            and sorted(secondary) == sorted(BENCH_SECONDARIES) and not failed
            and photo.get("launches") == steps):
        raise AssertionError(f"bench: {rec}")

    args, cfg = config5_frame(dev)
    fwd, bwd, rec["config5_frame"] = path_kernels(raster_cuda, args, cfg, seed=5)
    bins = {}
    for fields, name in ((fwd, "composite_fwd"), (bwd, "composite_bwd"), (bins, "tile_bin")):
        fields["launches"] = photo["launches"][name]
        fields["launches_per_step"] = photo["launches"][name] / steps[name]
    return rec, fwd, bwd, bins


def reset_launches(raster_cuda) -> None:
    from gaussiansplattingregistration_tpu_torch.ops import rasterize as R

    raster_cuda.composite_tiles.launches = 0
    raster_cuda.composite_tiles_bwd.launches = 0
    R.tile_bin.launches = 0


def read_launches(raster_cuda) -> dict:
    """The launches since `reset_launches`: each composite kernel's, and
    `tile_bin`'s, one a tile table built (so one a composite_fwd launch
    wherever only backend "cuda" renders)."""
    from gaussiansplattingregistration_tpu_torch.ops import rasterize as R

    torch.cuda.synchronize()
    return {"composite_fwd": raster_cuda.composite_tiles.launches,
            "composite_bwd": raster_cuda.composite_tiles_bwd.launches,
            "tile_bin": R.tile_bin.launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    if sys.argv[1:2] == ["--rank-worker"]:
        two_rank_worker(sys.argv[2], torch.device("cuda"))
        return 0
    from gaussiansplattingregistration_tpu_torch.ops import _build, raster_cuda, se3
    from gaussiansplattingregistration_tpu_torch.ops import rasterize as R
    from gaussiansplattingregistration_tpu_torch.pipelines import photometric

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()

    # 1. Card and toolchain.
    card = card_line(dev)
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

    # 3. Each kernel against its plain form: the card tests, in a pytest
    # subprocess. Then the tile table's times at the frames of the cells
    # that bin and of the main paths below.
    t0 = time.perf_counter()
    emit({"phase": "card_tests", **card_tests_phase(), "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    tile_bin_recs = {cell[0]: tile_bin_shape(*cell) for cell in tile_bin_cells(dev)}
    emit({"phase": "tile_bin", "cells": list(tile_bin_recs.values()),
          "seconds": time.perf_counter() - t0})

    # 4. The forward path at full width: the bench scene through
    # rasterize_arrays_with_stats, then the same frame on backend="torch".
    t0 = time.perf_counter()
    args, cfg = bench_scene(dev)

    reset_launches(raster_cuda)
    rgb, alpha, depth, stats = R.rasterize_arrays_with_stats(*args, cfg)
    launches_render = read_launches(raster_cuda)
    stats = {k: (float(v) if v.is_floating_point() else int(v)) for k, v in stats.items()}
    finite = all(bool(torch.isfinite(x).all()) for x in (rgb, alpha, depth))
    tcfg = dataclasses.replace(cfg, backend="torch")
    rgb_t, _, _ = R.rasterize_arrays(*args, tcfg)
    err_torch = float((rgb - rgb_t).abs().max())
    emit({"phase": "render", "splats": N_SPLATS, "width": WIDTH, "height": HEIGHT,
          "stats": stats, "launches": launches_render, "finite": finite,
          "rgb_max_abs_err_vs_torch_backend": err_torch,
          "mean_alpha": float(alpha.mean()), "seconds": time.perf_counter() - t0})
    if not finite:
        raise AssertionError("render is not finite")
    if stats["live_tile_overflow"] != 0:
        raise AssertionError(f"live_tile_overflow = {stats['live_tile_overflow']}")
    if launches_render["composite_fwd"] < 1:
        raise AssertionError("the render did not launch the composite kernel")
    if not err_torch <= 1e-4:
        raise AssertionError(f"cuda vs torch backend rgb differs by {err_torch}")

    # The kernels' inputs for this frame, as rasterize_tile_slab builds them.
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

    # The backward kernel vs its twin at the same shapes, seeded cotangents,
    # twice (bitwise equal).
    gen = np.random.default_rng(1)
    cts = [torch.tensor(gen.normal(size=s), dtype=torch.float32, device=dev)
           for s in ((T_live, ts * ts, 3), (T_live, ts * ts), (T_live, ts * ts))]
    d_got = raster_cuda.composite_tiles_bwd(gT, cnt, *cts, ts, cfg, fwd_out=got)
    d_again = raster_cuda.composite_tiles_bwd(gT, cnt, *cts, ts, cfg, fwd_out=got)
    torch.cuda.synchronize()
    d_want = raster_cuda.composite_tiles_reference_bwd(gT, cnt, *cts, ts, cfg)
    bwd_rec = check_bwd(d_got, d_want, "bench shapes")
    same = bool(torch.equal(d_got, d_again))
    emit({"phase": "bwd_kernel_vs_twin", "tiles": T_live, "K": cfg.max_splats_per_tile,
          **bwd_rec, "bitwise_deterministic": same})
    if not same:
        raise AssertionError("composite_bwd is not deterministic at bench scale")
    bwd_err = max(bwd_rec["max_abs_err"])
    del d_want, d_again

    # 5. Gradients at full width: d sum(rgb * ct) / d(means, cov, opacity,
    # features) on backend "cuda" (one composite_fwd and one composite_bwd
    # launch) against backend "torch" (plain autograd of the chunked
    # compositor), f32 transport. Tolerance: 1e-3 of each tensor's max abs,
    # the JAX suite's gradient tolerance.
    t0 = time.perf_counter()
    ct = torch.tensor(np.random.default_rng(2).uniform(-1, 1, (HEIGHT, WIDTH, 3)),
                      dtype=torch.float32, device=dev)

    def grads(config):
        params = [a.detach().clone().requires_grad_(True) for a in args[:4]]
        out = R.rasterize_arrays_with_stats(*params, *args[4:], config)
        return torch.autograd.grad((out[0] * ct).sum(), params), out[3]

    reset_launches(raster_cuda)
    g_cuda, gstats = grads(cfg)
    launches_grad = read_launches(raster_cuda)
    g_torch, _ = grads(tcfg)
    grad_rec = {}
    for name, a, b in zip(("means", "cov", "opacity", "features"), g_cuda, g_torch):
        grad_rec[name] = {"max_abs_err": float((a - b).abs().max()),
                          "scale": float(b.abs().max()),
                          "finite": bool(torch.isfinite(a).all())}
    emit({"phase": "grad", "launches": launches_grad, "grads": grad_rec,
          "live_tile_overflow": int(gstats["live_tile_overflow"]),
          "bwd_cap_violations": int(gstats["bwd_cap_violations"]),
          "seconds": time.perf_counter() - t0})
    if launches_grad != {"composite_fwd": 1, "composite_bwd": 1, "tile_bin": 1}:
        raise AssertionError(f"grad launches {launches_grad}, expected one of each")
    if int(gstats["live_tile_overflow"]) or int(gstats["bwd_cap_violations"]):
        raise AssertionError("the gradient frame overflowed a static bound")
    for name, rec in grad_rec.items():
        if not (rec["finite"] and rec["scale"] > 0 and rec["max_abs_err"] <= 1e-3 * rec["scale"]):
            raise AssertionError(f"cuda vs torch gradient of {name}: {rec}")
    del g_cuda, g_torch

    # 6. Timing on this card, this call. Kernels: device time per launch
    # from a profiler trace (`kernel_ms`, `bwd_kernel_ms`, the `kernels`
    # line's `ms`) and, beside it, CUDA events around back-to-back calls of
    # the wrapper (`*_wall_ms`), which include the host's launch gaps where
    # they exceed the kernel. The two measures differ; compare a kernel
    # across versions on one of them.
    frame_ms = cuda_ms(lambda: R.rasterize_arrays(*args, cfg), iters=10)
    frame_torch_ms = cuda_ms(lambda: R.rasterize_arrays(*args, tcfg), iters=3, warmup=1)
    kernel_ms = kernel_device_ms(lambda: raster_cuda.composite_tiles(gT, cnt, ts, cfg),
                                 "composite_fwd_kernel")
    kernel_wall_ms = cuda_ms(lambda: raster_cuda.composite_tiles(gT, cnt, ts, cfg), iters=20)
    plain_ms = cuda_ms(lambda: raster_cuda.composite_tiles_reference(gT, cnt, ts, cfg),
                       iters=3, warmup=1)
    bwd_ms = kernel_device_ms(
        lambda: raster_cuda.composite_tiles_bwd(gT, cnt, *cts, ts, cfg, fwd_out=got),
        "composite_bwd_kernel")
    bwd_wall_ms = cuda_ms(
        lambda: raster_cuda.composite_tiles_bwd(gT, cnt, *cts, ts, cfg, fwd_out=got), iters=20)
    bwd_plain_ms = cuda_ms(
        lambda: raster_cuda.composite_tiles_reference_bwd(gT, cnt, *cts, ts, cfg),
        iters=3, warmup=1)
    params = [a.detach().clone().requires_grad_(True) for a in args[:4]]

    def fwd_bwd(config):
        rgb_ = R.rasterize_arrays(*params, *args[4:], config)[0]
        return torch.autograd.grad(rgb_.sum(), params)

    # f32 and bf16 transport in turns (f32, bf16, bf16, f32): the eager
    # frame's time follows the host, which drifts within a call.
    bf16_cfg = dataclasses.replace(cfg, bwd_sort_bf16=True)
    turns = [cuda_ms(lambda c=c: fwd_bwd(c), iters=5) for c in (cfg, bf16_cfg, bf16_cfg, cfg)]
    train_ms, train_bf16_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    # Least time for each kernel's work on these inputs, whatever its
    # design: the whole formula on the visible pairs of this frame against
    # reading the function's inputs once and writing its outputs once. The
    # function reads only the entries before min(count, live) of each tile
    # (`read_entries`; nothing past them changes an output), the counts and,
    # backward, the cotangents; it writes [T, P, 5] and live forward, the
    # whole d_gT backward (`fwd_bound`). The forward outputs the backward
    # kernel also reads are a residual of its design and not counted.
    # Beside it, the pairs each design tests: `horizon_pairs` (the stats'
    # chunk-granular horizon, what the block-level exit visits),
    # `alive_pairs` and `candidate_pairs` (what the culled kernels test),
    # and the bound that charges the visibility test to every alive pair.
    fb = fwd_bound(gT, cnt, got, ts, cfg)
    pairs, read_entries = fb["pairs"], fb["read_entries"]
    ops_ms, bytes_ms, nbytes, bound_ms = (fb[k] for k in ("ops_bound_ms", "bytes_bound_ms",
                                                          "bytes", "bound_ms"))
    horizon_pairs = stats["mean_live"] * num_tiles * ts * ts
    bb = bwd_bound(gT, cnt, fb, ts)
    invisible_tests = (pairs["alive"] - pairs["visible"]) * OPS_TEST
    alive_ops_ms = (pairs["visible"] * (OPS_TEST + OPS_VISIBLE_FWD) + invisible_tests) \
        / PEAK_FP32_FLOPS * 1e3
    bwd_alive_ops_ms = (pairs["visible"] * (OPS_TEST + OPS_VISIBLE_BWD) + invisible_tests) \
        / PEAK_FP32_FLOPS * 1e3
    emit({"phase": "timing", "card": card, "frame_ms": frame_ms,
          "frame_mpx_per_s": WIDTH * HEIGHT / frame_ms / 1e3,
          "frame_torch_backend_ms": frame_torch_ms,
          "kernel_ms": kernel_ms, "kernel_mpx_per_s": WIDTH * HEIGHT / kernel_ms / 1e3,
          "kernel_wall_ms": kernel_wall_ms,
          "plain_ms": plain_ms, "horizon_pairs": horizon_pairs,
          "read_entries": read_entries,
          "alive_pairs": pairs["alive"], "candidate_pairs": pairs["candidate"],
          "visible_pairs": pairs["visible"],
          "ops_bound_ms": ops_ms, "bytes": nbytes, "bytes_bound_ms": bytes_ms,
          "bound_ms": bound_ms, "alive_ops_bound_ms": alive_ops_ms,
          "fwd_bwd_ms": train_ms, "fwd_bwd_mpx_per_s": WIDTH * HEIGHT / train_ms / 1e3,
          "fwd_bwd_bf16_ms": train_bf16_ms,
          "fwd_bwd_bf16_mpx_per_s": WIDTH * HEIGHT / train_bf16_ms / 1e3,
          "fwd_bwd_turns_ms": turns,
          "bwd_kernel_ms": bwd_ms, "bwd_kernel_wall_ms": bwd_wall_ms,
          "bwd_plain_ms": bwd_plain_ms,
          "bwd_ops_bound_ms": bb["ops_bound_ms"], "bwd_bytes": bb["bytes"],
          "bwd_bytes_bound_ms": bb["bytes_bound_ms"], "bwd_bound_ms": bb["bound_ms"],
          "bwd_alive_ops_bound_ms": bwd_alive_ops_ms})
    del params, cts, gT, cnt, inputs, want, got

    # 7. Photometric refinement at full width (the slice's main path): the
    # bench cloud against its own render under a known twist of norm ~0.02,
    # one 1280x720 camera, 11 Adam steps, each one composite_fwd and one
    # composite_bwd launch. Each step's wall time ends at a device sync in
    # the progress callback; the first step is the warm-up and is not timed.
    cloud, cam = bench_cloud(dev), bench_camera(dev)
    xi_true = torch.tensor([0.01, -0.008, 0.006, 0.008, -0.006, 0.01], device=dev)
    moved = cloud.transform(se3.se3_exp(xi_true))
    mstats = R.rasterize_arrays_with_stats(
        moved.xyz, moved.covariance, moved.get_opacity[:, 0], moved.get_features,
        cam.viewmat, cam.intrinsics, WIDTH, HEIGHT, 0, torch.zeros(3, device=dev), cfg)[3]
    if int(mstats["live_tile_overflow"]):
        raise AssertionError("the photometric target overflows max_live_tiles")
    targets = photometric.render_targets(moved, [cam], config=cfg, device=dev)
    steps = 11
    ends = []

    def step_end(_i, _loss):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())

    reset_launches(raster_cuda)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = photometric.photometric_pose_opt(cloud, [cam], targets, steps=steps,
                                              config=cfg, device=dev,
                                              progress_callback=step_end)
    launches_photo = read_launches(raster_cuda)
    step_ms = np.diff([t0] + ends) * 1e3
    T_true = se3.se3_exp(xi_true.double()).cpu().numpy()
    emit({"phase": "photometric", "splats": N_SPLATS, "width": WIDTH, "height": HEIGHT,
          "steps": steps, "warmup_step_ms": float(step_ms[0]),
          "ms_per_step": float(step_ms[1:].mean()), "ms_per_step_min": float(step_ms[1:].min()),
          "ms_per_step_max": float(step_ms[1:].max()), "step_ms": step_ms.tolist(),
          "loss_history": result.loss_history,
          "launches": launches_photo,
          "launches_per_step": {k: v / steps for k, v in launches_photo.items()},
          "pose_error_start": pose_error(np.eye(4), np.linalg.inv(T_true)),
          "pose_error_end": pose_error(result.transformation, np.linalg.inv(T_true))})
    if not np.isfinite(result.transformation).all():
        raise AssertionError("photometric pose is not finite")
    if not result.loss_history[-1] < result.loss_history[0]:
        raise AssertionError(f"photometric loss did not fall: {result.loss_history}")
    if launches_photo != {"composite_fwd": steps, "composite_bwd": steps, "tile_bin": steps}:
        raise AssertionError(f"photometric launches {launches_photo}, expected {steps} each")
    del cloud, moved, targets

    # 8. The CLI: `render` of the demo pair merged under the inverse of its
    # committed offset at the default 1280x720; then `photometric` on
    # tests/test_e2e_cli.py's scenario (3 views at 64x64, 80 steps at lr
    # 1e-3) from the true pose perturbed by a twist of norm ~0.02.
    cli = [sys.executable, "-m", "gaussiansplattingregistration_tpu_torch.cli"]
    data = os.path.join(REPO, "tests", "data")
    with open(os.path.join(data, "demo_transform.json")) as fh:
        T_fix = np.linalg.inv(np.asarray(json.load(fh)["T_offset"], np.float64))
    with tempfile.TemporaryDirectory() as tmp:
        out_png = os.path.join(tmp, "merged.png")
        proc = subprocess.run(
            cli + ["render", os.path.join(data, "demo_source.ply"), out_png,
                   "--second", os.path.join(data, "demo_target.ply"),
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

        cams_json, init_json, T_off = demo_photometric_views(tmp, 64, dev)
        out_json = os.path.join(tmp, "t.json")
        t0 = time.perf_counter()
        proc = subprocess.run(
            cli + ["photometric", os.path.join(data, "demo_source.ply"),
                   "--second", os.path.join(data, "demo_target.ply"),
                   "--cameras", cams_json, "--images-path", tmp,
                   "--init-transform", init_json, "--steps", "80", "--lr", "1e-3",
                   "--output", out_json],
            cwd=REPO, capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            raise AssertionError(f"cli photometric failed (rc {proc.returncode}):\n"
                                 f"{proc.stderr[-3000:]}")
        photo_out = json.loads(proc.stdout.strip().splitlines()[-1])
        with open(init_json) as fh:
            err0 = pose_error(json.load(fh)["transformation"], T_off)
        err = pose_error(photo_out["transformation"], T_off)
        emit({"phase": "cli_photometric", "rc": proc.returncode,
              "final_loss": photo_out["final_loss"], "steps": photo_out["steps"],
              "pose_error_start": err0, "pose_error_end": err,
              "seconds": time.perf_counter() - t0})
        if not err < 2e-2:
            raise AssertionError(f"cli photometric pose error {err} >= 2e-2")

    # 9. The registration path (plain torch on the card, but the brute
    # neighbor search, which runs knn_brute): neighbor search, ICP, HEM,
    # multiscale at bench.py's sizes, then the end-to-end CLI flow, whose
    # evaluation runs composite_fwd.
    surf_src, surf_tgt, T_surf, vol_src, vol, T_vol = icp_draws(100_000)
    reg_recs = {}
    for phase, fn in (("knn", lambda: knn_phase(dev, surf_src, surf_tgt, (vol, vol_src))),
                      ("icp", lambda: icp_phase(dev, (surf_src, surf_tgt, T_surf),
                                                (vol_src, vol, T_vol.astype(np.float64))))):
        t0 = time.perf_counter()
        rec = reg_recs[phase] = fn()
        emit({"phase": phase, "card": card, **rec, "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    hem_rec, hem_cloud, hem_levels = hem_phase(dev)
    emit({"phase": "hem", "card": card, **hem_rec, "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    ms_rec = multiscale_phase(dev, hem_cloud, hem_levels)
    emit({"phase": "multiscale", "card": card, **ms_rec, "seconds": time.perf_counter() - t0})
    reg_launches = {"icp": reg_recs["icp"]["knn_brute"]["launches"],
                    "hem": hem_rec["knn_brute"]["launches"],
                    "multiscale": ms_rec["knn_brute"]["launches"]}
    del hem_cloud, hem_levels
    with tempfile.TemporaryDirectory() as tmp:
        emit({"phase": "cli_e2e", "card": card, **cli_e2e_phase(dev, raster_cuda, tmp)})

    # 10. Global registration, planes, the viewer and their CLI (plain
    # torch on the card, no kernel of their own; the viewer's frames run
    # composite_fwd).
    for phase, fn in (("global", lambda: global_phase(dev)), ("planes", lambda: planes_phase(dev))):
        t0 = time.perf_counter()
        rec = fn()
        emit({"phase": phase, "card": card, **rec, "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    viewer_rec, viewer_fwd = viewer_phase(dev, raster_cuda)
    emit({"phase": "viewer", "card": card, **viewer_rec, "seconds": time.perf_counter() - t0})
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rec = cli_global_planes_phase(dev, tmp)
        emit({"phase": "cli_global_planes", "card": card, **rec,
              "seconds": time.perf_counter() - t0})

    # 11. The multi-GPU path: NCCL at world size 1 in this process at full
    # width (its sharded train steps are the `sharded_train_step` path),
    # two gloo ranks sharing the card in two processes, and `evaluate
    # --sharded on` in this process.
    t0 = time.perf_counter()
    world1_rec, world1_fwd, world1_bwd = parallel_world1_phase(dev, raster_cuda)
    emit({"phase": "parallel_world1", "card": card, **world1_rec,
          "seconds": time.perf_counter() - t0})
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rec = parallel_two_ranks_phase(tmp)
        emit({"phase": "parallel_two_ranks", "card": card, **rec,
              "seconds": time.perf_counter() - t0})
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rec = cli_sharded_eval_phase(dev, raster_cuda, tmp)
        emit({"phase": "cli_sharded_eval", "card": card, **rec,
              "seconds": time.perf_counter() - t0})

    # 12. bench_torch.py, the port's benchmark runner, on the card, and both
    # kernels on the inputs of its config 5 (bench.py's photometric config).
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        bench_rec, bench_fwd, bench_bwd, bench_bins = bench_phase(dev, raster_cuda, tmp)
        emit({"phase": "bench", "card": card, **bench_rec,
              "seconds": time.perf_counter() - t0})

    # 13. Every ported kernel on each main path, with that path's launches
    # (counts set to 0 just before the path and read just after it) and
    # the numbers measured on that path's inputs: the full-width
    # photometric run (bench config, K = 384), the viewer's six frames
    # (the viewer's config, K = 256; no backward), the world-1 sharded
    # train steps (bench config; the inputs of their second camera) and
    # bench_torch.py's config 5 (K = 256; its 10 timed steps' launches,
    # counted in its own process); then the kNN kernel, which replaces no
    # TPU kernel: its launches in the registration path's icp, hem and
    # multiscale phases (`brute_launches`), beside its times at the
    # registration cell's shapes (`knn_kernel_times`); then the tile-binning
    # kernel, which replaces no TPU kernel either, on the same four paths:
    # its launches there (one a table) and the `tile_bin` phase's numbers
    # on the path's own frame, the photometric path's beside the two
    # cells' frames (`TILE_BIN_PATH_CELLS`).
    src = "gaussiansplattingregistration_tpu_torch/csrc/"
    ref = "gaussiansplattingregistration_tpu/ops/raster_pallas.py:"
    fwd = {"name": "composite_fwd", "route": "cuda", "source": src + "composite_fwd.cu",
           "replaces": ref + "173"}
    bwd = {"name": "composite_bwd", "route": "cuda", "source": src + "composite_bwd.cu",
           "replaces": ref + "270"}
    bins = {"name": "tile_bin", "route": "cuda", "source": src + "tile_bin.cu", "replaces": None,
            "bound_by": "bytes", "library_ms": None}

    def bin_shapes(path):
        return [{k: tile_bin_recs[cell][k] for k in TILE_BIN_FIELDS}
                for cell in TILE_BIN_PATH_CELLS[path]]

    emit({"kernels": [
        {**fwd, "path": "photometric", "launches": launches_photo["composite_fwd"],
         "max_abs_err": max(errs), "ms": kernel_ms, "plain_ms": plain_ms,
         "bound_ms": bound_ms, "bound_by": fb["bound_by"], "library_ms": None},
        {**fwd, "path": "viewer", **viewer_fwd, "library_ms": None},
        {**bwd, "path": "photometric",
         "launches": launches_photo["composite_bwd"],
         "max_abs_err": bwd_err, "ms": bwd_ms, "plain_ms": bwd_plain_ms,
         "bound_ms": bb["bound_ms"], "bound_by": bb["bound_by"], "library_ms": None},
        {**fwd, "path": "sharded_train_step", **world1_fwd, "library_ms": None},
        {**bwd, "path": "sharded_train_step", **world1_bwd, "library_ms": None},
        {**fwd, "path": "bench_config5", **bench_fwd, "library_ms": None},
        {**bwd, "path": "bench_config5", **bench_bwd, "library_ms": None},
        {"name": "knn_brute", "route": "cuda", "source": src + "knn_brute.cu", "replaces": None,
         "path": "registration", "launches": sum(reg_launches.values()),
         "launches_by_phase": reg_launches,
         "shapes": [{"case": c["case"], "Q": c["Q"], "N": c["N"], "k": c["k"],
                     "ms": c["kernel_ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                     "bound_share": c["bound_share"]}
                    for c in reg_recs["knn"]["kernel"]],
         "bound_by": "fp32_issue", "library_ms": None},
        {**bins, "path": "photometric", "launches": launches_photo["tile_bin"],
         "shapes": bin_shapes("photometric")},
        {**bins, "path": "viewer", "launches": viewer_rec["launches"]["tile_bin"],
         "shapes": bin_shapes("viewer")},
        {**bins, "path": "sharded_train_step",
         "launches": world1_rec["path_launches"]["tile_bin"],
         "shapes": bin_shapes("sharded_train_step")},
        {**bins, "path": "bench_config5", **bench_bins, "shapes": bin_shapes("bench_config5")},
    ]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
