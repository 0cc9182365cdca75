"""Driver of the photometric cells: a closed loop of Adam steps of the
program's photometric pose refinement
(`pipelines/photometric.py::PhotometricRefiner`), one step of the run loop
being one `step()` over every view.

Two captures of the configuration's room are drawn from two streams of the
seed (`seed` and `seed + 1`). The first stays (the fixed capture, merged
into every render); the second is the new capture, moved by a rigid
motion. The targets are the program's `render_targets` of the pair at the
truth, drawn in set-up. A job starts from `xi` = 0 with fresh Adam state
on the capture moved by one of `motions` fixed motions (each of
`translation` and `angle_deg`, drawn by numpy from `motion_seed`; the run's
seed draws their order) and runs `steps_per_job` steps; then the next job
starts. A job's end pose is read to the host.

Traffic parameters (`traffic/<mix>.json`): `motions`, `motion_seed`,
`translation`, `angle_deg`, `steps_per_job`, `learning_rate`,
`ssim_weight`, `warmup_steps` (steps in set-up), `trace_steps`,
`check_views` (views of the last step the reference computes again, drawn
from the seed), `oracle_k_round` (the exact render's K is its longest tile
run rounded up to this) and `limits`.

The configuration gives the scene (`scene`, `splats` a capture), the
cameras (`cameras`: `width`, `height`, `fov_deg` horizontal, `distance`
from the room's centre in the horizontal plane, `height_z`, `yaws_deg`
about z, each camera looking at the centre) and the rasterizer.

Control (`--control`): "tf32", the reference with matmuls and cuDNN
convolutions in TF32 in the program's place: at each view the check
compares, the last step's render, loss share and gradient of `xi` are the
TF32 reference's from the same `xi`; the step's summed gradient and its
updated `xi` (a sum and Adam, with no matmul or convolution) are the
program's held at TF32's 10-bit mantissa. The window runs the program.
"""

from __future__ import annotations

import dataclasses
import math
import sys

import numpy as np
import torch

from gaussiansplattingregistration_tpu_torch.models.camera import Camera
from gaussiansplattingregistration_tpu_torch.models.gaussian_cloud import GaussianCloud
from gaussiansplattingregistration_tpu_torch.ops import rasterize as port_raster
from gaussiansplattingregistration_tpu_torch.pipelines.photometric import (
    PhotometricRefiner,
    render_targets,
)
from splatbench import scenes
from splatbench.drivers.raster import _port_config
from splatbench.drivers.registration import _pose_gap
from splatbench.reference import photometric as ref
from splatbench.reference import raster as ref_raster
from splatbench.roofline import composite as roofline


@dataclasses.dataclass
class State:
    ctx: object
    views: list
    width: int
    height: int
    sh_degree: int
    port_config: object
    ref_params: ref_raster.RasterParams
    fixed: dict
    moving: list
    motions: list
    targets: list
    refiner: object
    steps_per_job: int
    job: int = 0
    job_step: int = 0
    results: list = dataclasses.field(default_factory=list)
    traced: list = dataclasses.field(default_factory=list)
    gate_stats: dict = dataclasses.field(default_factory=dict)
    last: dict = dataclasses.field(default_factory=dict)


def look_at_views(cams: dict, device) -> list:
    """[(viewmat [4, 4], intrinsics [3, 3])] of each yaw: the camera
    `distance` from the origin in the plane z = `height_z`, looking at the
    origin, z up, x right and y down in the image."""
    W, H = int(cams["width"]), int(cams["height"])
    f = W / (2.0 * math.tan(math.radians(cams["fov_deg"]) / 2.0))
    intr = torch.tensor([[f, 0.0, W / 2.0], [0.0, f, H / 2.0], [0.0, 0.0, 1.0]],
                        dtype=torch.float64)
    out = []
    for yaw in cams["yaws_deg"]:
        y = math.radians(yaw)
        pos = np.array([cams["distance"] * math.cos(y), cams["distance"] * math.sin(y),
                        cams["height_z"]])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        rot = np.stack([right, np.cross(fwd, right), fwd])           # world to camera
        view = np.eye(4)
        view[:3, :3], view[:3, 3] = rot, -rot @ pos
        out.append((torch.tensor(view, dtype=torch.float32, device=device),
                    intr.to(torch.float32).to(device)))
    return out


def check_cameras(scene: dict, views) -> None:
    """Raises where a camera is outside the room or inside one of its boxes."""
    for vm, _ in views:
        centre = -(vm[:3, :3].T @ vm[:3, 3]).double().cpu().numpy()
        if np.any(np.abs(centre) >= np.array(scene["room"]) / 2):
            raise ValueError(f"camera at {centre} is outside the room")
        for box in scene["boxes"]:
            if np.all(np.abs(centre - np.array(box[:3])) <= np.array(box[3:]) / 2):
                raise ValueError(f"camera at {centre} is inside the box {box}")


def port_cameras(views, width: int, height: int) -> list:
    """The program's cameras of the views (rotation camera-to-world, the
    world-to-camera translation)."""
    return [Camera(rotation=vm[:3, :3].T.contiguous(), position=vm[:3, 3].clone(),
                   fx=intr[0, 0].clone(), fy=intr[1, 1].clone(), width=width, height=height)
            for vm, intr in views]


def arrays(raw: dict) -> dict:
    """The rasterizer's inputs of a capture's raw arrays: means, packed
    covariances, activated opacities, the SH stack."""
    return {"means": raw["xyz"], "cov": raw["covariance"],
            "opacity": torch.sigmoid(raw["opacity"][:, 0]),
            "features": torch.cat([raw["features_dc"], raw["features_rest"]], dim=1)}


def cloud(raw: dict, sh_degree: int, device) -> GaussianCloud:
    """The program's cloud of a capture's raw arrays, with its packed
    covariance as drawn."""
    return GaussianCloud.create(raw["xyz"], raw["features_dc"], raw["features_rest"],
                                raw["opacity"], raw["scaling"], raw["rotation"],
                                sh_degree=sh_degree, covariance=raw["covariance"],
                                device=device)


def moved(raw: dict, motion: np.ndarray) -> dict:
    """The capture moved by `motion`: `scenes.move_capture`'s positions and
    covariances, and quaternions turned with it (q_motion ⊗ q)."""
    out = scenes.move_capture(raw, motion)
    w1, x1, y1, z1 = torch.as_tensor(scenes._quat_of(motion[:3, :3]), dtype=torch.float32,
                                     device=raw["rotation"].device).unbind()
    w2, x2, y2, z2 = raw["rotation"].unbind(-1)
    out["rotation"] = torch.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                                   w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                                   w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                                   w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], dim=-1)
    return out


def setup(ctx) -> State:
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    if ctx.control not in (None, "tf32"):
        raise ValueError(f"unknown photometric control {ctx.control!r}")
    cams, deg = cfg["cameras"], int(cfg["scene"]["sh_degree"])
    W, H = int(cams["width"]), int(cams["height"])
    views = look_at_views(cams, dev)
    check_cameras(cfg["scene"], views)
    cameras = port_cameras(views, W, H)
    port_config = _port_config(cfg["rasterizer"], None)
    fixed_raw = scenes.reg_scene(cfg["scene"], cfg["splats"], ctx.seed, dev)
    moving_raw = scenes.reg_scene(cfg["scene"], cfg["splats"], ctx.seed + 1, dev)
    fixed_cloud = cloud(fixed_raw, deg, dev)
    truth = cloud(moving_raw, deg, dev)
    targets = render_targets(truth.merge(fixed_cloud), cameras, config=port_config, device=dev)
    n = int(tr["motions"])
    fixed_motions = scenes.rigid_motions(int(tr["motion_seed"]), n, tr["translation"],
                                         tr["angle_deg"])
    rng = np.random.default_rng(int(ctx.seed) % (2 ** 63))
    motions = [fixed_motions[i] for i in rng.permutation(n)]
    moving = [moved(moving_raw, m) for m in motions]
    del truth, moving_raw
    refiner = PhotometricRefiner(cloud(moving[0], deg, dev), cameras, targets,
                                 fixed_cloud=fixed_cloud, learning_rate=tr["learning_rate"],
                                 ssim_weight=tr["ssim_weight"], config=port_config, device=dev)
    st = State(ctx=ctx, views=views, width=W, height=H, sh_degree=deg,
               port_config=port_config,
               ref_params=ref_raster.RasterParams.from_config(cfg["rasterizer"]),
               fixed=arrays(fixed_raw), moving=moving, motions=motions, targets=targets,
               refiner=refiner, steps_per_job=int(tr["steps_per_job"]))
    _gates(st, ref.posed_arrays(torch.zeros(6, device=dev), torch.eye(4, device=dev),
                                arrays(moving[0]), st.fixed))
    for _ in range(int(tr["warmup_steps"])):
        _step(st)
    refiner.restart()
    return st


def _gates(st: State, posed) -> None:
    """The configuration's gates at every view from the program's counters:
    no tile's gradient cut by the backward cap, no live tile past
    max_live_tiles."""
    bg = torch.zeros(3, device=st.ctx.device)
    with torch.no_grad():
        for vm, intr in st.views:
            stats = port_raster.rasterize_arrays_with_stats(
                *posed, vm, intr, st.width, st.height, st.sh_degree, bg, st.port_config,
                device=st.ctx.device)[3]
            for key in ("bwd_cap_violations", "live_tile_overflow"):
                st.gate_stats[key] = max(st.gate_stats.get(key, 0), int(stats.get(key, 0)))


def _adam_state(opt, xi) -> dict:
    """`xi`'s gradient and Adam's moments as the optimizer is about to
    step (zeros before a job's first step)."""
    s = opt.state.get(xi) or {}
    zero = torch.zeros_like(xi)
    return {"grad": xi.grad.detach().clone(),
            "exp_avg": s["exp_avg"].detach().clone() if s else zero,
            "exp_avg_sq": s["exp_avg_sq"].detach().clone() if s else zero}


def _step(st: State) -> None:
    """One step of the program, keeping what the check reads: `xi` before
    and after the step, the step's count in its job, each view's render,
    loss share and gradient of `xi` (a hook on `xi`, which each view's
    backward reaches once), and the summed gradient and Adam's moments as
    the optimizer steps (its step pre-hook)."""
    r = st.refiner
    grads, adam = [], {}
    hook = r.xi.register_hook(lambda g: grads.append(g.detach().clone()))
    pre = r.opt.register_step_pre_hook(lambda opt, args, kwargs:
                                       adam.update(_adam_state(opt, r.xi)))
    xi = r.xi.detach().clone()
    try:
        r.step(keep_renders=True)
    finally:
        hook.remove()
        pre.remove()
    st.last = {"job": st.job, "t": st.job_step + 1, "xi": xi, "grads": grads,
               "renders": r.last_renders, "losses": r.last_losses, "adam": adam,
               "xi_after": r.xi.detach().clone()}


def step(st: State, i: int) -> None:
    """One Adam step over every view; after the job's last step its pose
    is read and the next job starts."""
    _step(st)
    st.job_step += 1
    if st.job_step == st.steps_per_job:
        st.results.append({"job": st.job, "pose": st.refiner.transformation,
                           "motion": st.motions[st.job % len(st.motions)]})
        st.job += 1
        st.job_step = 0
        nxt = st.moving[st.job % len(st.moving)]
        st.refiner.restart(cloud(nxt, st.sh_degree, st.ctx.device))


def traced_step(st: State, i: int) -> None:
    st.traced.append((st.job, st.refiner.xi.detach().clone()))
    step(st, i)


def window_metrics(st: State, window_s: float, steps: int) -> dict:
    return {"fwd_bwd_pixels_per_s": st.width * st.height * len(st.views) * steps / window_s}


def spans(st: State) -> dict:
    return {}


def work(st: State, card) -> dict:
    """The least device seconds of the composite kernels over the traced
    steps: every view of each traced step at the step's `xi`, counted by
    `roofline/composite.py` under the configuration's C and K."""
    if card is None or not st.traced:
        return {}
    out = {"composite_fwd": 0.0, "composite_bwd": 0.0}
    eye = torch.eye(4, device=st.ctx.device)
    with torch.no_grad():
        for job, xi in st.traced:
            posed = ref.posed_arrays(xi, eye, arrays(st.moving[job % len(st.moving)]),
                                     st.fixed)
            for vm, intr in st.views:
                w = roofline.frame_work(posed[0], posed[1], posed[2], vm, intr, st.width,
                                        st.height, st.ref_params)
                out["composite_fwd"] += roofline.bound_s(roofline.forward_cost(w), card)
                out["composite_bwd"] += roofline.bound_s(roofline.backward_cost(w), card)
            del posed
    print(f"# roofline work over {len(st.traced)} traced steps: {out}", file=sys.stderr)
    return out


def release(st: State) -> None:
    """Frees the program's refiner before the check's reference runs."""
    st.refiner = None


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.clamp_min(torch.linalg.vector_norm(b.double()), 1e-30))


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 `x` rounded to TF32's 10-bit mantissa (to nearest)."""
    bits = x.detach().to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _update_gaps(st: State) -> dict:
    """The last step's summed gradient against the sum of its views'
    gradients, and its updated `xi` against `ref.adam_step` from the
    program's `xi`, summed gradient and moments before the step at the
    step's count in its job, by the norm of the gap over the learning
    rate."""
    last, lr = st.last, float(st.ctx.traffic["learning_rate"])
    adam = last["adam"]
    got_grad, got_xi = adam["grad"], last["xi_after"]
    if st.ctx.control == "tf32":
        got_grad, got_xi = _tf32(got_grad), _tf32(got_xi)
    want_xi = ref.adam_step(last["xi"], adam["grad"], adam["exp_avg"], adam["exp_avg_sq"],
                            last["t"], lr)[0]
    print(f"# step {last['t']} of job {last['job']}: xi {last['xi'].tolist()} -> "
          f"{got_xi.tolist()} / {want_xi.tolist()}", file=sys.stderr)
    return {"grad_sum_rel_gap": _rel(got_grad, torch.stack(last["grads"]).double().sum(0)),
            "adam_step_gap_per_lr": float(torch.linalg.vector_norm(
                (got_xi - want_xi).double())) / lr}


def check(st: State) -> dict:
    """The numbers the run is judged by: the window's last step at
    `check_views` views drawn from the seed against the reference from
    the same `xi` and raw inputs (render, loss share, gradient of `xi` by
    its translation and rotation parts), the step's summed gradient and
    Adam update (`_update_gaps`), the truncation oracle and the gates at
    that pose, and every completed job's end pose against the truth."""
    tr, dev = st.ctx.traffic, st.ctx.device
    last = st.last
    moving = arrays(st.moving[last["job"] % len(st.moving)])
    t_init = torch.eye(4, device=dev)
    nums = {"rgb_rms_gap": 0.0, "rgb_max_gap": 0.0, "loss_rel_gap": 0.0,
            "grad_trans_rel_gap": 0.0, "grad_rot_rel_gap": 0.0, **_update_gaps(st)}
    rng = np.random.default_rng((int(st.ctx.seed) + 11) % (2 ** 63))
    k = min(int(tr["check_views"]), len(st.views))
    picks = sorted(rng.choice(len(st.views), size=k, replace=False).tolist())
    psnrs = {}
    args = (t_init, moving, st.fixed)
    with ref_raster.precision(tf32=False):
        posed = ref.posed_arrays(last["xi"], t_init, moving, st.fixed)
        _gates(st, posed)
        for v in picks:
            view = (st.views[v], st.targets[v], st.width, st.height, st.sh_degree,
                    st.ref_params, tr["ssim_weight"], len(st.views))
            want = ref.view_step(last["xi"], *args, *view)
            got_rgb, got_loss, got_grad = last["renders"][v], last["losses"][v], last["grads"][v]
            if st.ctx.control == "tf32":
                with ref_raster.precision(tf32=True):
                    got = ref.view_step(last["xi"], *args, *view)
                got_rgb, got_loss, got_grad = got["rgb"], float(got["loss"]), got["grad"]
            gaps = {"rgb_rms_gap": float(torch.sqrt(torch.mean((got_rgb - want["rgb"]) ** 2))),
                    "rgb_max_gap": float((got_rgb - want["rgb"]).abs().max()),
                    "loss_rel_gap": abs(got_loss - float(want["loss"]))
                    / max(abs(float(want["loss"])), 1e-30),
                    "grad_trans_rel_gap": _rel(got_grad[:3], want["grad"][:3]),
                    "grad_rot_rel_gap": _rel(got_grad[3:], want["grad"][3:])}
            for key, val in gaps.items():
                nums[key] = max(nums[key], val)
            exact, k_exact, live = ref.exact_render(*posed, *st.views[v], st.width, st.height,
                                                    st.sh_degree, st.ref_params,
                                                    int(tr["oracle_k_round"]))
            psnrs[v] = ref.psnr(got_rgb, torch.clamp(exact, 0.0, 1.0))
            print(f"# view {v}: {gaps}, loss {got_loss!r} / {float(want['loss'])!r}, "
                  f"grad {got_grad.tolist()} / {want['grad'].tolist()}, "
                  f"K_exact {k_exact}, tiles with entries {live}, psnr {psnrs[v]!r}",
                  file=sys.stderr)
            del want, exact
    nums["truncation_psnr_min_db"] = min(psnrs.values())
    for key in ("bwd_cap_violations", "live_tile_overflow"):
        nums[key] = float(st.gate_stats[key])
    nums.update({"truth_rot_err_deg": 0.0, "truth_trans_err": 0.0,
                 "jobs_completed": float(len(st.results))})
    for r in st.results:
        rot, trans = _pose_gap(r["pose"] @ r["motion"], np.eye(4))
        print(f"# job {r['job']}: {rot!r} deg, {trans!r} from the truth", file=sys.stderr)
        nums["truth_rot_err_deg"] = max(nums["truth_rot_err_deg"], rot)
        nums["truth_trans_err"] = max(nums["truth_trans_err"], trans)
    return nums
