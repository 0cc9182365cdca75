"""CLI of the torch port: `info` and `render` (more subcommands follow the
port; see ROADMAP.md).

  info          inspect a PLY (type sniffing)
  render        rasterize a cloud (or merged pair) to PNG

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


def cmd_render(args):
    from gaussiansplattingregistration_tpu_torch.ops import math3d
    from gaussiansplattingregistration_tpu_torch.ops.rasterize import RasterizeConfig, rasterize
    from gaussiansplattingregistration_tpu_torch.utils import io as gio

    cloud = gio.load_gaussian_cloud(args.input, device=args.device)
    if args.second:
        second = gio.load_gaussian_cloud(args.second, device=args.device)
        cloud = cloud.merge(second, _load_transform(args.transform))
    elif args.transform:
        cloud = cloud.transform(_load_transform(args.transform))
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

    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
