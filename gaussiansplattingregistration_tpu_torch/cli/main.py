"""CLI of the torch port: the JAX CLI's subcommands that the port has so
far, with its flags and the JSON keys it prints.

  info          inspect a PLY (type sniffing)
  register      local ICP (point-to-point, -plane, colored, generalized),
                global RANSAC or FGR on FPFH features; optionally on
                plane-inlier subsets (--plane-inliers-first/--second)
  multiscale    coarse-to-fine voxel or HEM-mixture registration
  downsample    HEM Gaussian-mixture levels
  render        rasterize a cloud (or merged pair) to PNG
  view          interactive browser viewer
  evaluate      photometric evaluation vs GT images
  merge         transform + concatenate + save
  fit-planes    sequential RANSAC plane fitting
  merge-planes  per-plane HEM merging
  photometric   differentiable pose registration through the rasterizer

`evaluate --sharded on` splits the cameras over the ranks of the process
group (`auto`: when there is more than one rank); the multi-GPU form is
`torchrun --nproc-per-node N -m gaussiansplattingregistration_tpu_torch.cli
evaluate --sharded on ...`, and only rank 0 prints.

Transforms are passed as 16-value row-major 4x4 or JSON files
{"transformation": [[...]]}. `--device cuda` (the default) needs a card;
`--device cpu` runs the same path with the kernels' plain twins.
"""

from __future__ import annotations

import argparse
import json
import math
import os

import numpy as np


def _load_transform(spec):
    if spec is None:
        return np.eye(4)
    try:
        vals = [float(v) for v in spec.replace(",", " ").split()]
        if len(vals) == 16:
            return np.asarray(vals, np.float64).reshape(4, 4)
    except ValueError:
        pass
    with open(spec) as f:
        data = json.load(f)
    key = "transformation" if "transformation" in data else "result_transformation"
    return np.asarray(data[key], np.float64)


def _save_transform(T, path, extra=None):
    out = {"transformation": np.asarray(T).tolist()}
    out.update(extra or {})
    if path:
        with open(path, "w") as f:
            json.dump(out, f, indent=2)
    print(json.dumps(out))


_ICP_TYPES = ("point_to_point", "point_to_plane", "colored", "generalized")
_KERNELS = ("none", "tukey", "cauchy", "gm", "huber")


def _icp_type(name):
    from gaussiansplattingregistration_tpu_torch.models.parameters import LocalRegistrationType

    return {
        "point_to_point": LocalRegistrationType.ICP_POINT_TO_POINT,
        "point_to_plane": LocalRegistrationType.ICP_POINT_TO_PLANE,
        "colored": LocalRegistrationType.ICP_COLOR,
        "generalized": LocalRegistrationType.ICP_GENERAL,
    }[name]


def _load_pair(args):
    from gaussiansplattingregistration_tpu_torch.utils import io as gio

    return (gio.load_point_cloud_any(args.first, device=args.device),
            gio.load_point_cloud_any(args.second, device=args.device))


def _as_point_cloud(obj, estimate_normals=False):
    from gaussiansplattingregistration_tpu_torch.models.gaussian_cloud import GaussianCloud
    from gaussiansplattingregistration_tpu_torch.utils import io as gio

    if isinstance(obj, GaussianCloud):
        return gio.gaussian_to_point_cloud(obj, estimate_missing_normals=estimate_normals)
    return obj


def _mixture_params(args, cluster_level):
    from gaussiansplattingregistration_tpu_torch.models.parameters import GaussianMixtureParams

    return GaussianMixtureParams(
        hem_reduction=args.hem_reduction, distance_delta=args.distance_delta,
        color_delta=args.color_delta, decay_rate=args.decay_rate,
        cluster_level=cluster_level,
    )


def cmd_info(args):
    from gaussiansplattingregistration_tpu_torch.models.gaussian_cloud import GaussianCloud
    from gaussiansplattingregistration_tpu_torch.utils import io as gio

    obj = gio.load_point_cloud_any(args.input, device=args.device)
    if isinstance(obj, GaussianCloud):
        xyz = obj.xyz.cpu().numpy()
        info = {"type": "gaussian", "num_points": obj.num_points,
                "sh_degree": obj.sh_degree}
    else:
        xyz = obj.points.cpu().numpy()
        info = {"type": "sparse", "num_points": obj.num_points,
                "has_normals": obj.normals is not None}
    info["aabb_min"] = xyz.min(0).tolist()
    info["aabb_max"] = xyz.max(0).tolist()
    print(json.dumps(info))


def cmd_register(args):
    from gaussiansplattingregistration_tpu_torch.models import parameters as P

    if bool(args.plane_inliers_first) != bool(args.plane_inliers_second):
        raise SystemExit(
            "--plane-inliers-first and --plane-inliers-second must be given together "
            "(inlier registration registers plane-inlier subsets of both clouds)")
    first, second = _load_pair(args)
    init = _load_transform(args.init_transform)
    src, tgt = _as_point_cloud(first), _as_point_cloud(second)
    if args.plane_inliers_first:
        from gaussiansplattingregistration_tpu_torch.pipelines.planes import (
            load_plane_indices,
            select_plane_inliers,
        )

        src = select_plane_inliers(src, load_plane_indices(args.plane_inliers_first))
        tgt = select_plane_inliers(tgt, load_plane_indices(args.plane_inliers_second))

    if args.method in ("ransac", "fgr"):
        from gaussiansplattingregistration_tpu_torch.ops import global_registration as gr

        # Global registration composes with the current transform: it runs
        # on the moved source, and the result is applied after `init`.
        moved = src.transform(init)
        if args.method == "ransac":
            checkers = [P.CorrespondenceChecker(kind, value) for kind, value in (
                ("edge_length", args.checker_edge_length), ("distance", args.checker_distance),
                ("normal", args.checker_normal)) if value is not None]
            params = P.RANSACRegistrationParams(
                voxel_size=args.voxel_size, mutual_filter=args.mutual_filter,
                max_correspondence=args.max_correspondence, ransac_n=args.ransac_n,
                checkers=tuple(checkers), max_iteration=args.max_iteration,
                confidence=args.confidence,
            )
            result = gr.ransac_registration(moved, tgt, params, seed=args.seed)
        else:
            params = P.FGRRegistrationParams(
                voxel_size=args.voxel_size, maximum_correspondence=args.fgr_max_correspondence,
                max_iterations=args.max_iteration if args.max_iteration != 100000 else 64,
            )
            result = gr.fgr_registration(moved, tgt, params, seed=args.seed)
        final = result.transformation @ init
    else:
        from gaussiansplattingregistration_tpu_torch.ops import icp as icp_ops

        params = P.LocalRegistrationParams(
            registration_type=_icp_type(args.method),
            max_correspondence=args.max_correspondence,
            relative_fitness=args.relative_fitness,
            relative_rmse=args.relative_rmse,
            max_iteration=args.max_iteration if args.max_iteration != 100000 else 30,
            rejection_type=P.KernelLossFunctionType[args.kernel.upper()],
            k_value=args.k_value,
        )
        result = icp_ops.icp(src, tgt, params, init_transform=init)
        final = result.transformation  # local results replace the transform
    _save_transform(
        final, args.output,
        {"fitness": result.fitness, "inlier_rmse": result.inlier_rmse,
         "num_iterations": result.num_iterations},
    )


def cmd_multiscale(args):
    from gaussiansplattingregistration_tpu_torch.models import parameters as P
    from gaussiansplattingregistration_tpu_torch.pipelines import multiscale as ms

    first, second = _load_pair(args)
    init = _load_transform(args.init_transform)
    params = P.MultiScaleRegistrationParams(
        registration_type=_icp_type(args.icp_type),
        voxel_values=[float(v) for v in args.voxel_values.split(",")],
        iter_values=[int(v) for v in args.iter_values.split(",")],
        use_corresponding_pc=args.sparse_first is not None,
    )
    if args.use_mixture:
        from gaussiansplattingregistration_tpu_torch.models.gaussian_cloud import GaussianCloud
        from gaussiansplattingregistration_tpu_torch.ops import hem

        if not isinstance(first, GaussianCloud) or not isinstance(second, GaussianCloud):
            raise SystemExit("--use-mixture requires Gaussian PLY inputs")
        mix_params = _mixture_params(args, max(len(params.voxel_values) - 1, 1))

        def levels(cloud):
            lvls = hem.create_mixture(cloud, mix_params, seed=args.seed)
            clouds = hem.mixture_levels_to_clouds(lvls, cloud.sh_degree, device=args.device)
            return [_as_point_cloud(c) for c in [cloud] + clouds]

        result = ms.multiscale_mixture_registration(levels(first), levels(second), params,
                                                    init_transform=init)
    else:
        sparse_src = sparse_tgt = None
        if args.sparse_first and args.sparse_second:
            from gaussiansplattingregistration_tpu_torch.utils import io as gio

            sparse_src = gio.load_sparse_cloud(args.sparse_first, device=args.device)
            sparse_tgt = gio.load_sparse_cloud(args.sparse_second, device=args.device)
        result = ms.multiscale_voxel_registration(
            _as_point_cloud(first), _as_point_cloud(second), params, init_transform=init,
            sparse_source=sparse_src, sparse_target=sparse_tgt,
        )
    _save_transform(
        result.transformation, args.output,
        {"fitness": result.fitness, "inlier_rmse": result.inlier_rmse},
    )


def cmd_downsample(args):
    from gaussiansplattingregistration_tpu_torch.ops import hem
    from gaussiansplattingregistration_tpu_torch.utils import io as gio

    cloud = gio.load_gaussian_cloud(args.input, device=args.device)
    levels = hem.create_mixture(cloud, _mixture_params(args, args.cluster_level), seed=args.seed)
    clouds = hem.mixture_levels_to_clouds(levels, cloud.sh_degree, device=args.device)
    out = {"input_points": cloud.num_points, "levels": []}
    for i, c in enumerate(clouds, start=1):
        path = f"{args.output_prefix}_level{i}.ply"
        gio.save_gaussian_cloud(c, path)
        out["levels"].append({"level": i, "points": c.num_points, "path": path})
    print(json.dumps(out))


def _make_cli_camera(args, aabb_center, aabb_extent):
    """Camera from eye/lookat/up (or defaults framing the scene AABB), in the
    +z-forward (COLMAP/3DGS) convention the rasterizer expects."""
    from gaussiansplattingregistration_tpu_torch.models.camera import Camera

    if args.fov:
        fov = math.radians(args.fov) if args.fov > math.pi else args.fov
        f_px = args.width / (2 * math.tan(fov / 2))
    elif args.focal:
        f_px = args.focal
    else:
        f_px = args.width / (2 * math.tan(math.radians(60) / 2))

    eye = np.asarray(
        [float(v) for v in args.eye.split(",")]
        if args.eye
        else aabb_center + np.array([0, 0, -2.0 * max(aabb_extent, 1e-3)])
    )
    lookat = np.asarray(
        [float(v) for v in args.lookat.split(",")]
        if args.lookat
        else aabb_center
    )
    up = np.asarray(
        [float(v) for v in args.up.split(",")] if args.up else [0.0, -1.0, 0.0]
    )
    z = lookat - eye
    z = z / max(np.linalg.norm(z), 1e-12)
    x = np.cross(up, z)
    x = x / max(np.linalg.norm(x), 1e-12)
    y = np.cross(z, x)
    R_w2c = np.stack([x, y, z])
    t = -R_w2c @ eye
    viewmat = np.eye(4)
    viewmat[:3, :3] = R_w2c
    viewmat[:3, 3] = t
    cam = Camera.create(np.eye(3), np.zeros(3), f_px, f_px,
                        args.width, args.height, device=args.device)
    return cam.with_viewmat(np.asarray(viewmat, np.float32))


def _to_png(path, img):
    from gaussiansplattingregistration_tpu_torch.utils.png import write_png

    write_png(path, (np.clip(img.cpu().numpy(), 0, 1) * 255).astype(np.uint8))


def _load_render_cloud(args):
    """The input cloud, merged with --second under --transform or moved by
    --transform alone."""
    from gaussiansplattingregistration_tpu_torch.utils import io as gio

    cloud = gio.load_gaussian_cloud(args.input, device=args.device)
    if args.second:
        second = gio.load_gaussian_cloud(args.second, device=args.device)
        return cloud.merge(second, _load_transform(args.transform))
    if args.transform:
        return cloud.transform(_load_transform(args.transform))
    return cloud


def cmd_render(args):
    from gaussiansplattingregistration_tpu_torch.ops import math3d
    from gaussiansplattingregistration_tpu_torch.ops.rasterize import RasterizeConfig, rasterize

    cloud = _load_render_cloud(args)
    xyz = cloud.xyz.cpu().numpy()
    center = (xyz.min(0) + xyz.max(0)) / 2
    extent = float(np.linalg.norm(xyz.max(0) - xyz.min(0)))
    cam = _make_cli_camera(args, center, extent)

    bg = [float(v) for v in args.background.split(",")]
    config = RasterizeConfig(max_splats_per_tile=args.max_splats_per_tile,
                             backend=args.backend)

    if args.orbit > 1:
        # Turntable render: N frames of the cloud rotated about world +y.
        import torch

        base, ext = os.path.splitext(args.output)
        outputs = []
        for i in range(args.orbit):
            angle = 2.0 * math.pi * i / args.orbit
            R = math3d.axis_angle_to_rotmat(
                torch.tensor([0.0, 1.0, 0.0], device=cloud.device),
                torch.tensor(angle, device=cloud.device))
            T = torch.eye(4, device=cloud.device)
            T[:3, :3] = R
            rotated = cloud.transform(T, rotate_sh=False)
            rgb, _, _ = rasterize(rotated, cam, background=bg, scaling_modifier=args.scale,
                                  config=config, device=args.device)
            path = f"{base}_{i:03d}{ext}"
            _to_png(path, rgb)
            outputs.append(path)
        print(json.dumps({"outputs": outputs, "frames": args.orbit}))
        return

    rgb, alpha, depth = rasterize(cloud, cam, background=bg, scaling_modifier=args.scale,
                                  config=config, device=args.device)
    _to_png(args.output, rgb)
    out = {"output": args.output, "width": args.width,
           "height": args.height, "mean_alpha": float(alpha.mean())}
    if args.depth_output:
        dmax = float(depth.max())
        _to_png(args.depth_output, depth / (dmax if dmax > 0 else 1.0))
        out["depth_output"] = args.depth_output
    print(json.dumps(out))


def cmd_view(args):
    """Interactive browser viewer (see pipelines/viewer.py); serves until
    interrupted."""
    import time

    from gaussiansplattingregistration_tpu_torch.ops.rasterize import RasterizeConfig
    from gaussiansplattingregistration_tpu_torch.pipelines import viewer as viewer_mod

    cloud = _load_render_cloud(args)
    config = RasterizeConfig(max_splats_per_tile=args.max_splats_per_tile, backend=args.backend)
    server, _ = viewer_mod.serve(cloud, host=args.host, port=args.port, width=args.width,
                                 height=args.height, config=config, device=args.device)
    host, port = server.server_address[:2]
    print(f"viewer: http://{host}:{port}/  ({cloud.num_points} splats; Ctrl-C to stop)",
          flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.shutdown()
    return 0


def cmd_evaluate(args):
    from gaussiansplattingregistration_tpu_torch.parallel import distributed
    from gaussiansplattingregistration_tpu_torch.pipelines.evaluation import (
        evaluate_registration,
        evaluate_registration_sharded,
        load_cameras_json,
    )
    from gaussiansplattingregistration_tpu_torch.utils import io as gio

    sharded = args.sharded == "on" or (args.sharded == "auto" and distributed.world_size() > 1)
    # The group comes first: under torchrun it picks this rank's card.
    created = sharded and distributed.initialize(device=args.device)
    try:
        first = gio.load_gaussian_cloud(args.first, device=args.device)
        second = gio.load_gaussian_cloud(args.second, device=args.device)
        common = (first, second, _load_transform(args.transform),
                  load_cameras_json(args.cameras, device=args.device), args.images_path)
        bg = [float(v) for v in args.background.split(",")]
        if sharded:
            result = evaluate_registration_sharded(*common, background=bg, log_path=args.log,
                                                   device=args.device)
        else:
            result = evaluate_registration(*common, background=bg, log_path=args.log,
                                           use_lpips=not args.no_lpips, device=args.device)
        primary = distributed.is_primary()
    finally:
        if created:
            distributed.shutdown()
    if primary:
        print(json.dumps(result.as_log_dict()))


def cmd_merge(args):
    from gaussiansplattingregistration_tpu_torch.pipelines.merge import merge_from_paths

    merged = merge_from_paths(args.first, args.second, _load_transform(args.transform),
                              args.output, device=args.device)
    print(json.dumps({"output": args.output, "num_points": merged.num_points}))


def cmd_fit_planes(args):
    from gaussiansplattingregistration_tpu_torch.models.parameters import PlaneFittingParams
    from gaussiansplattingregistration_tpu_torch.ops.plane_fitting import fit_planes
    from gaussiansplattingregistration_tpu_torch.utils import io as gio

    obj = gio.load_point_cloud_any(args.input, device=args.device)
    pc = _as_point_cloud(obj, estimate_normals=True)
    params = PlaneFittingParams(
        plane_count=args.plane_count, iterations=args.iterations,
        distance_threshold=args.distance_threshold, normal_threshold=args.normal_threshold,
        min_distance=args.min_distance,
    )
    planes, inliers = fit_planes(pc, params, seed=args.seed)
    out = {"planes": [p.tolist() for p in planes], "inlier_counts": [len(i) for i in inliers]}
    if args.output:
        with open(args.output, "w") as f:
            json.dump({**out, "inlier_indices": [i.tolist() for i in inliers]}, f)
    print(json.dumps(out))


def cmd_merge_planes(args):
    from gaussiansplattingregistration_tpu_torch.pipelines.planes import (
        load_plane_indices,
        merge_plane_inliers,
    )
    from gaussiansplattingregistration_tpu_torch.utils import io as gio

    cloud = gio.load_gaussian_cloud(args.input, device=args.device)
    plane_indices = load_plane_indices(args.planes)
    levels = merge_plane_inliers(cloud, plane_indices, _mixture_params(args, args.cluster_level),
                                 seed=args.seed)
    n_plane = int(sum(len(ix) for ix in plane_indices))
    out = {"input_points": cloud.num_points, "plane_points": n_plane,
           "unselected_points": cloud.num_points - n_plane, "levels": []}
    for i, c in enumerate(levels, start=1):
        path = f"{args.output_prefix}_level{i}.ply"
        gio.save_gaussian_cloud(c, path)
        out["levels"].append({"level": i, "points": c.num_points, "path": path})
    print(json.dumps(out))


def cmd_photometric(args):
    from gaussiansplattingregistration_tpu_torch.ops.rasterize import RasterizeConfig
    from gaussiansplattingregistration_tpu_torch.pipelines.evaluation import (
        load_cameras_json,
        load_image,
    )
    from gaussiansplattingregistration_tpu_torch.pipelines.photometric import (
        photometric_pose_opt,
    )
    from gaussiansplattingregistration_tpu_torch.utils import io as gio

    source = gio.load_gaussian_cloud(args.first, device=args.device)
    fixed = gio.load_gaussian_cloud(args.second, device=args.device) if args.second else None
    cameras = load_cameras_json(args.cameras, device=args.device)
    if args.max_cameras:
        cameras = cameras[: args.max_cameras]
    targets = [load_image(os.path.join(args.images_path, c.image_name + ".png"))
               for c in cameras]
    result = photometric_pose_opt(
        source, cameras, targets,
        init_transform=_load_transform(args.init_transform),
        fixed_cloud=fixed, steps=args.steps, learning_rate=args.lr,
        ssim_weight=args.ssim_weight, config=RasterizeConfig(backend=args.backend),
        device=args.device,
    )
    _save_transform(
        result.transformation, args.output,
        {"final_loss": result.final_loss, "steps": result.num_steps},
    )


def build_parser():
    p = argparse.ArgumentParser(
        prog="gsr-torch",
        description="Gaussian Splatting registration framework (PyTorch/CUDA port)",
    )
    sub = p.add_subparsers(dest="command", required=True)

    def add_device(sp):
        sp.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cpu runs the kernels' plain twins")

    sp = sub.add_parser("info", help="inspect a PLY file")
    sp.add_argument("input")
    add_device(sp)
    sp.set_defaults(fn=cmd_info)

    sp = sub.add_parser("register", help="local ICP or global RANSAC/FGR registration")
    sp.add_argument("first")
    sp.add_argument("second")
    sp.add_argument("--method", default="point_to_point",
                    choices=[*_ICP_TYPES, "ransac", "fgr"])
    sp.add_argument("--init-transform")
    sp.add_argument("--output")
    sp.add_argument("--max-correspondence", type=float, default=5.0)
    sp.add_argument("--relative-fitness", type=float, default=1e-6)
    sp.add_argument("--relative-rmse", type=float, default=1e-6)
    sp.add_argument("--max-iteration", type=int, default=100000)
    sp.add_argument("--kernel", default="none", choices=list(_KERNELS))
    sp.add_argument("--k-value", type=float, default=0.0)
    sp.add_argument("--voxel-size", type=float, default=0.05)
    sp.add_argument("--mutual-filter", action="store_true")
    sp.add_argument("--ransac-n", type=int, default=3)
    sp.add_argument("--confidence", type=float, default=0.999)
    sp.add_argument("--checker-edge-length", type=float)
    sp.add_argument("--checker-distance", type=float)
    sp.add_argument("--checker-normal", type=float)
    sp.add_argument("--fgr-max-correspondence", type=float, default=0.025)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--plane-inliers-first",
                    help="fit-planes --output JSON for the first cloud: "
                         "register on the plane-inlier subsets only")
    sp.add_argument("--plane-inliers-second",
                    help="fit-planes --output JSON for the second cloud")
    add_device(sp)
    sp.set_defaults(fn=cmd_register)

    sp = sub.add_parser("multiscale", help="coarse-to-fine registration")
    sp.add_argument("first")
    sp.add_argument("second")
    sp.add_argument("--icp-type", default="point_to_point", choices=list(_ICP_TYPES))
    sp.add_argument("--voxel-values", default="0.1,0.05,0.01")
    sp.add_argument("--iter-values", default="50,30,14")
    sp.add_argument("--use-mixture", action="store_true")
    sp.add_argument("--hem-reduction", type=float, default=3.0)
    sp.add_argument("--distance-delta", type=float, default=3.0)
    sp.add_argument("--color-delta", type=float, default=2.5)
    sp.add_argument("--decay-rate", type=float, default=1.0)
    sp.add_argument("--sparse-first")
    sp.add_argument("--sparse-second")
    sp.add_argument("--init-transform")
    sp.add_argument("--output")
    sp.add_argument("--seed", type=int, default=0)
    add_device(sp)
    sp.set_defaults(fn=cmd_multiscale)

    sp = sub.add_parser("downsample", help="HEM Gaussian-mixture downsampling")
    sp.add_argument("input")
    sp.add_argument("output_prefix")
    sp.add_argument("--hem-reduction", type=float, default=3.0)
    sp.add_argument("--distance-delta", type=float, default=3.0)
    sp.add_argument("--color-delta", type=float, default=2.5)
    sp.add_argument("--decay-rate", type=float, default=1.0)
    sp.add_argument("--cluster-level", type=int, default=3)
    sp.add_argument("--seed", type=int, default=0)
    add_device(sp)
    sp.set_defaults(fn=cmd_downsample)

    sp = sub.add_parser("render", help="rasterize a cloud to PNG")
    sp.add_argument("input")
    sp.add_argument("output")
    sp.add_argument("--second", help="merge a second cloud before rendering")
    sp.add_argument("--transform", help="transform applied to the first cloud")
    sp.add_argument("--width", type=int, default=1280)
    sp.add_argument("--height", type=int, default=720)
    sp.add_argument("--fov", type=float, help="field of view (deg or rad)")
    sp.add_argument("--focal", type=float, help="focal length fx (px)")
    sp.add_argument("--eye", help="camera position x,y,z")
    sp.add_argument("--lookat", help="look-at point x,y,z")
    sp.add_argument("--up", help="up vector x,y,z")
    sp.add_argument("--background", default="0,0,0")
    sp.add_argument("--scale", type=float, default=1.0,
                    help="covariance scaling modifier")
    sp.add_argument("--max-splats-per-tile", type=int, default=256)
    sp.add_argument("--backend", default="cuda", choices=["cuda", "torch"])
    add_device(sp)
    sp.add_argument("--orbit", type=int, default=1,
                    help="render N turntable frames around the scene")
    sp.add_argument("--depth-output", help="also save a normalized depth map PNG")
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("view", help="interactive browser viewer")
    sp.add_argument("input")
    sp.add_argument("--second")
    sp.add_argument("--transform")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8765)
    sp.add_argument("--width", type=int, default=960)
    sp.add_argument("--height", type=int, default=720)
    sp.add_argument("--max-splats-per-tile", type=int, default=256)
    sp.add_argument("--backend", default="cuda", choices=["cuda", "torch"])
    add_device(sp)
    sp.set_defaults(fn=cmd_view)

    sp = sub.add_parser("evaluate", help="photometric evaluation vs GT images")
    sp.add_argument("first")
    sp.add_argument("second")
    sp.add_argument("--transform")
    sp.add_argument("--cameras", required=True, help="cameras.json")
    sp.add_argument("--images-path", required=True)
    sp.add_argument("--log")
    sp.add_argument("--background", default="0,0,0")
    sp.add_argument("--no-lpips", action="store_true")
    sp.add_argument("--sharded", default="auto", choices=["auto", "on", "off"],
                    help="camera-sharded evaluation over the process group's ranks "
                         "(auto: on when there is more than one)")
    add_device(sp)
    sp.set_defaults(fn=cmd_evaluate)

    sp = sub.add_parser("merge", help="merge two clouds under a transform")
    sp.add_argument("first")
    sp.add_argument("second")
    sp.add_argument("output")
    sp.add_argument("--transform")
    add_device(sp)
    sp.set_defaults(fn=cmd_merge)

    sp = sub.add_parser("fit-planes", help="sequential RANSAC plane fitting")
    sp.add_argument("input")
    sp.add_argument("--plane-count", type=int, default=1)
    sp.add_argument("--iterations", type=int, default=100)
    sp.add_argument("--distance-threshold", type=float, default=0.01)
    sp.add_argument("--normal-threshold", type=float, default=0.9)
    sp.add_argument("--min-distance", type=float, default=0.05)
    sp.add_argument("--output")
    sp.add_argument("--seed", type=int, default=0)
    add_device(sp)
    sp.set_defaults(fn=cmd_fit_planes)

    sp = sub.add_parser(
        "merge-planes",
        help="per-plane HEM merging: plane inliers downsampled plane-by-plane, "
             "off-plane points passed through unchanged",
    )
    sp.add_argument("input")
    sp.add_argument("planes", help="fit-planes --output JSON for this cloud")
    sp.add_argument("output_prefix")
    sp.add_argument("--hem-reduction", type=float, default=3.0)
    sp.add_argument("--distance-delta", type=float, default=3.0)
    sp.add_argument("--color-delta", type=float, default=2.5)
    sp.add_argument("--decay-rate", type=float, default=1.0)
    sp.add_argument("--cluster-level", type=int, default=3)
    sp.add_argument("--seed", type=int, default=0)
    add_device(sp)
    sp.set_defaults(fn=cmd_merge_planes)

    sp = sub.add_parser("photometric", help="differentiable pose registration")
    sp.add_argument("first", help="cloud whose pose is optimized")
    sp.add_argument("--second", help="fixed cloud merged into the render")
    sp.add_argument("--cameras", required=True)
    sp.add_argument("--images-path", required=True)
    sp.add_argument("--max-cameras", type=int)
    sp.add_argument("--steps", type=int, default=100)
    sp.add_argument("--lr", type=float, default=5e-3)
    sp.add_argument("--ssim-weight", type=float, default=0.2)
    sp.add_argument("--init-transform")
    sp.add_argument("--output")
    sp.add_argument("--backend", default="cuda", choices=["cuda", "torch"])
    add_device(sp)
    sp.set_defaults(fn=cmd_photometric)

    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
