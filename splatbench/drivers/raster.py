"""Driver of the render cells: a closed loop of rasterizer frames over a
splat scene, cycling the traffic's camera yaws.

Traffic parameters (`traffic/<mix>.json`):
- `mode`: "fwd_bwd" (a training or refinement view: forward, the L1 loss
  against a target image drawn from the seed, and `torch.autograd.grad`
  with respect to means, covariances, opacities and features) or "fwd"
  (one client's forward renders under `no_grad`, each timed from its call
  to a synchronize);
- `yaws`: the camera's yaws about y, in radians, cycled frame by frame;
- `warmup_rounds`: rounds over the yaws in set-up;
- `trace_steps`: frames in the traced window of a `--trace 1` run;
- `oracle_k_round`: the exact render's K is the longest tile run rounded
  up to this;
- `limits`: the numbers compared and their limits.

Controls (`--control`): "tf32", the reference in the program's place with
TF32 matmuls; "bf16_transport", the program with its bf16 cotangent
transport switched on.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time

import torch

from gaussiansplattingregistration_tpu_torch.ops import rasterize as port_raster
from splatbench import scenes
from splatbench.reference import raster
from splatbench.roofline import composite as roofline

GRAD_NAMES = ("means", "cov3d", "opacity", "features")


@dataclasses.dataclass
class State:
    ctx: object
    scene: tuple
    views: list
    width: int
    height: int
    sh_degree: int
    port_config: object
    ref_params: raster.RasterParams
    train: bool
    params: list = None
    target: torch.Tensor = None
    last: dict = dataclasses.field(default_factory=dict)
    latencies: list = dataclasses.field(default_factory=list)
    gate_stats: dict = dataclasses.field(default_factory=dict)
    traced_views: list = dataclasses.field(default_factory=list)


def _port_config(rz: dict, control):
    """The program's RasterizeConfig: every field the configuration states,
    on the "cuda" backend (its kernels on a card, their plain twins on CPU
    tensors)."""
    fields = {f.name for f in dataclasses.fields(port_raster.RasterizeConfig)}
    cfg = port_raster.RasterizeConfig(**{k: v for k, v in rz.items() if k in fields},
                                      backend="cuda")
    if control == "bf16_transport":
        cfg = dataclasses.replace(cfg, bwd_sort_bf16=True)
    elif control not in (None, "tf32"):
        raise ValueError(f"unknown raster control {control!r}")
    return cfg


def setup(ctx) -> State:
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    cam = cfg["camera"]
    W, H = int(cam["width"]), int(cam["height"])
    scene = scenes.splat_scene(cfg["scene"], ctx.seed, dev)
    views = [raster.camera(y, W, H, cam["fov_deg"], cam["distance"], dev) for y in tr["yaws"]]
    st = State(ctx=ctx, scene=scene, views=views, width=W, height=H,
               sh_degree=int(cfg["scene"]["sh_degree"]),
               port_config=_port_config(cfg["rasterizer"], ctx.control),
               ref_params=raster.RasterParams.from_config(cfg["rasterizer"]),
               train=tr["mode"] == "fwd_bwd")
    if tr["mode"] not in ("fwd_bwd", "fwd"):
        raise ValueError(f"unknown raster traffic mode {tr['mode']!r}")
    if st.train:
        st.target = torch.rand((H, W, 3), generator=scenes.generator(ctx.seed + 1, dev),
                               device=dev)
        st.params = [a.detach().clone().requires_grad_(True) for a in scene]
    # The configuration's gate, from the program's counters: no tile's
    # gradient cut by the backward cap and no live tile past max_live_tiles,
    # at every pose.
    bg = torch.zeros(3, device=dev)
    for vm, intr in views:
        stats = port_raster.rasterize_arrays_with_stats(
            *scene, vm, intr, W, H, st.sh_degree, bg, st.port_config, device=dev)[3]
        for key in ("bwd_cap_violations", "live_tile_overflow"):
            st.gate_stats[key] = max(st.gate_stats.get(key, 0), int(stats.get(key, 0)))
    for i in range(int(tr["warmup_rounds"]) * len(views)):
        step(st, i)
    st.latencies.clear()
    return st


def _frame(st: State, v: int):
    vm, intr = st.views[v]
    W, H, deg, dev = st.width, st.height, st.sh_degree, st.ctx.device
    if st.ctx.control == "tf32":
        with raster.precision(tf32=True):
            return raster.render(*(st.params if st.train else st.scene), vm, intr, W, H, deg,
                                 st.ref_params)
    bg = torch.zeros(3, device=dev)
    return port_raster.rasterize_arrays(*(st.params if st.train else st.scene), vm, intr, W, H,
                                        deg, bg, st.port_config, device=dev)


def step(st: State, i: int) -> None:
    """One frame at yaw i mod the yaw count."""
    v = i % len(st.views)
    if st.train:
        rgb, alpha, depth = _frame(st, v)
        loss = torch.mean(torch.abs(rgb - st.target))
        with raster.precision(tf32=st.ctx.control == "tf32"):
            grads = torch.autograd.grad(loss, st.params)
        st.last[v] = {"rgb": rgb.detach(), "alpha": alpha.detach(), "depth": depth.detach(),
                      "grads": grads}
        return
    t0 = time.perf_counter()
    with torch.no_grad():
        rgb, alpha, depth = _frame(st, v)
    st.ctx.sync()
    st.latencies.append(time.perf_counter() - t0)
    st.last[v] = {"rgb": rgb, "alpha": alpha, "depth": depth}


def window_metrics(st: State, window_s: float, steps: int) -> dict:
    if st.train:
        return {"fwd_bwd_pixels_per_s": st.width * st.height * steps / window_s}
    return {"render_mean_ms": 1e3 * window_s / steps}


def spans(st: State) -> dict:
    return {"render": list(st.latencies)} if st.latencies else {}


def traced_step(st: State, i: int) -> None:
    st.traced_views.append(i % len(st.views))
    step(st, i)


def work(st: State, card) -> dict:
    """The least device seconds of the composite kernels over the traced
    frames, by the reference's count of each pose's work."""
    if card is None or not st.traced_views:
        return {}
    out = {"composite_fwd": 0.0, "composite_bwd": 0.0} if st.train else {"composite_fwd": 0.0}
    p = st.ref_params
    for v in sorted(set(st.traced_views)):
        vm, intr = st.views[v]
        w = roofline.frame_work(st.scene[0], st.scene[1], st.scene[2], vm, intr,
                                st.width, st.height, p)
        n = st.traced_views.count(v)
        out["composite_fwd"] += n * roofline.bound_s(roofline.forward_cost(w), card)
        if st.train:
            out["composite_bwd"] += n * roofline.bound_s(roofline.backward_cost(w), card)
        print(f"# roofline work at yaw {v}: {w}", file=sys.stderr)
    return out


def release(st: State) -> None:
    """Frees what the program holds beyond the outputs the check reads."""
    st.params = None


def _psnr(a, b) -> float:
    mse = float(torch.mean((a - b) ** 2))
    return 10.0 * math.log10(1.0 / max(mse, 1e-12))


TAIL_GAPS = (1e-3, 1e-2)


def _grad_gaps(got, want) -> dict:
    """The gaps of one leaf's gradient: the norm of the difference over the
    reference's norm (`l2`), and over the splats whose reference
    gradient is above a thousandth of the median splat's, each splat's
    relative gap: its median, its 99th and 99.9th percentiles, and the
    share of those splats whose gap is above each of TAIL_GAPS."""
    a = got.reshape(got.shape[0], -1).double()
    b = want.reshape(want.shape[0], -1).double()
    rel = float(torch.linalg.vector_norm(a - b) / torch.clamp_min(torch.linalg.vector_norm(b), 1e-30))
    nb = torch.linalg.vector_norm(b, dim=1)
    floor = 1e-3 * torch.median(nb[nb > 0]) if bool((nb > 0).any()) else torch.tensor(0.0)
    keep = nb > floor
    per = torch.linalg.vector_norm(a - b, dim=1)[keep] / nb[keep]
    out = {"l2": rel, "median": 0.0, "p99": 0.0, "p999": 0.0}
    out.update({f"share_above_{t:g}": 0.0 for t in TAIL_GAPS})
    if per.numel():
        q = torch.quantile(per.float(), torch.tensor([0.5, 0.99, 0.999], device=per.device))
        out.update(median=float(q[0]), p99=float(q[1]), p999=float(q[2]))
        out.update({f"share_above_{t:g}": float((per > t).double().mean()) for t in TAIL_GAPS})
    return out


def check(st: State) -> dict:
    """The numbers the run is judged by: the window's last frame at each
    pose against the reference's frame (and gradients) from the same raw
    inputs, the truncation oracle, and the configuration's gate."""
    p, W, H, deg, dev = st.ref_params, st.width, st.height, st.sh_degree, st.ctx.device
    nums = {f"{k}_{s}_gap": 0.0 for k in ("rgb", "alpha", "depth") for s in ("max", "rms")}
    if st.train:
        nums.update({"grad_l2_rel_gap": 0.0, "grad_median_rel_gap": 0.0})
    with raster.precision(tf32=False):
        probe = 0
        for vm, intr in st.views:
            proj = raster.project(st.scene[0], st.scene[1], vm, intr, W, H, p)
            b = raster.bin_tiles(proj["means2d"], proj["radius"], proj["depth"], proj["valid"],
                                 -(-W // p.tile_size), -(-H // p.tile_size), p,
                                 max_splats_per_tile=1, max_tiles_per_splat=8)
            probe = max(probe, int(b["max_run"]))
        r = int(st.ctx.traffic["oracle_k_round"])
        k_exact = -(-probe // r) * r
        psnrs = []
        for v, (vm, intr) in enumerate(st.views):
            out = st.last[v]
            inputs = [a.detach().clone().requires_grad_(st.train) for a in st.scene]
            with torch.set_grad_enabled(st.train):
                rgb, alpha, depth = raster.render(*inputs, vm, intr, W, H, deg, p)
            ref = {"rgb": rgb.detach(), "alpha": alpha.detach(), "depth": depth.detach()}
            gaps = {f"{k}_max_gap": float((out[k] - ref[k]).abs().max()) for k in ref}
            gaps.update({f"{k}_rms_gap": float(torch.sqrt(torch.mean((out[k] - ref[k]) ** 2)))
                         for k in ref})
            if st.train:
                loss = torch.mean(torch.abs(rgb - st.target))
                ref_grads = torch.autograd.grad(loss, inputs)
                for name, g_p, g_r in zip(GRAD_NAMES, out["grads"], ref_grads):
                    leaf = _grad_gaps(g_p, g_r)
                    print(f"# yaw {v} grad {name}: {leaf}", file=sys.stderr)
                    for k, val in leaf.items():
                        key = f"grad_{k}" if k.startswith("share") else f"grad_{k}_rel_gap"
                        gaps[key] = max(gaps.get(key, 0.0), val)
                del ref_grads, loss
            for k, val in gaps.items():
                nums[k] = max(nums.get(k, 0.0), val)
            print(f"# yaw {v}: {gaps}", file=sys.stderr)
            del rgb, alpha, depth, inputs
            with torch.no_grad():
                exact = raster.render(*st.scene, vm, intr, W, H, deg, p, chunk=8,
                                      max_splats_per_tile=k_exact, max_tiles_per_splat=8)[0]
            psnrs.append(_psnr(out["rgb"], exact))
            del exact
    print(f"# truncation oracle: K_exact {k_exact}, psnr per pose {psnrs}", file=sys.stderr)
    nums["truncation_psnr_min_db"] = min(psnrs)
    for key in ("bwd_cap_violations", "live_tile_overflow"):
        if key in st.gate_stats:
            nums[key] = float(st.gate_stats[key])
    return nums
