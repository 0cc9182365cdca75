"""Interactive 3DGS viewer: a local HTTP server driving the port's rasterizer.

Torch counterpart of `gaussiansplattingregistration_tpu/pipelines/viewer.py`,
with the same page, endpoints and clamps: a browser page against a
stateless render endpoint. The mouse mapping is left-drag rotate,
ctrl/middle-drag translate, shift-drag roll, wheel zoom (rotate 0.01/px,
translate 7/px, roll 0.1/px, zoom 0.01/step). The camera is rebuilt per
request from the cumulative orbit parameters, so the server holds no
mutable view state and every frame is reproducible from its URL.

Each request renders once through `ops.rasterize.rasterize` with the
scene's configured backend (`cuda`: one `composite_fwd` launch per frame),
on the scene's device, one render at a time under the scene's lock. Frames
are encoded by `utils/png.py`.

Endpoints:
  GET /                   the viewer page (embedded HTML/JS)
  GET /state              scene metadata JSON (splat count, AABB, SH degree)
  GET /render?yaw=&pitch=&roll=&panx=&pany=&zoom=&w=&h=   PNG frame
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from gaussiansplattingregistration_tpu_torch.models.camera import Camera
from gaussiansplattingregistration_tpu_torch.ops.rasterize import (
    DEFAULT_CONFIG,
    RasterizeConfig,
    rasterize,
)
from gaussiansplattingregistration_tpu_torch.utils.device import resolve_device
from gaussiansplattingregistration_tpu_torch.utils.png import encode_png

_PAGE = """<!DOCTYPE html>
<html><head><title>gsr-tpu viewer</title><style>
  body { margin: 0; background: #191d23; color: #ccc;
         font: 13px sans-serif; overflow: hidden; }
  #hud { position: fixed; left: 8px; top: 8px; opacity: 0.8; }
  img  { display: block; cursor: grab; }
</style></head><body>
<div id="hud">drag: rotate &middot; ctrl/middle-drag: pan &middot;
shift-drag: roll &middot; wheel: zoom</div>
<img id="view" draggable="false">
<script>
const img = document.getElementById('view');
let view = {yaw: 0, pitch: 0, roll: 0, panx: 0, pany: 0, zoom: 0};
let drag = null, inflight = false, dirty = false;
function url() {
  const q = new URLSearchParams(view);
  q.set('w', Math.min(window.innerWidth, 1600));
  q.set('h', Math.min(window.innerHeight, 1200));
  return '/render?' + q.toString();
}
function refresh() {
  if (inflight) { dirty = true; return; }
  inflight = true;
  const probe = new Image();
  probe.onload = () => {
    img.src = probe.src; inflight = false;
    if (dirty) { dirty = false; refresh(); }
  };
  probe.onerror = () => { inflight = false; };
  probe.src = url();
}
img.addEventListener('mousedown', e => {
  const mode = (e.button === 1 || e.ctrlKey) ? 'pan'
             : e.shiftKey ? 'roll' : 'rotate';
  drag = {x: e.clientX, y: e.clientY, mode: mode, start: {...view}};
  e.preventDefault();
});
window.addEventListener('mousemove', e => {
  if (!drag) return;
  const dx = e.clientX - drag.x, dy = e.clientY - drag.y;
  view = {...drag.start};
  if (drag.mode === 'rotate') {            // rotate_speed = 0.01
    view.yaw = drag.start.yaw + dx * 0.01;
    view.pitch = drag.start.pitch + dy * 0.01;
  } else if (drag.mode === 'pan') {        // translate_speed = 7
    view.panx = drag.start.panx + dx * 7;
    view.pany = drag.start.pany + dy * 7;
  } else {                                 // roll_speed = 0.1
    view.roll = drag.start.roll + dx * 0.1;
  }
  refresh();
});
window.addEventListener('mouseup', () => { drag = null; });
window.addEventListener('wheel', e => {    // zoom_factor = 0.01
  view.zoom += e.deltaY * 0.01;
  refresh();
});
window.addEventListener('resize', refresh);
refresh();
</script></body></html>
"""


class ViewerScene:
    """Immutable scene + the per-request camera/render logic, on `device`
    (default `cuda`; the cloud is moved there once)."""

    def __init__(
        self,
        cloud,
        width: int = 960,
        height: int = 720,
        background=(0.098, 0.137, 0.176),
        config: RasterizeConfig = DEFAULT_CONFIG,
        fov_deg: float = 60.0,
        device=None,
    ):
        self.device = resolve_device(device)
        if cloud.device != self.device:
            cloud = dataclasses.replace(cloud, **{
                f.name: getattr(cloud, f.name).to(self.device)
                for f in dataclasses.fields(cloud) if f.name != "sh_degree"})
        self.cloud = cloud
        self.width = width
        self.height = height
        self.background = tuple(float(b) for b in background)
        self.config = config
        self.fov_deg = float(fov_deg)
        xyz = cloud.xyz.detach().cpu().numpy()
        self.aabb_min = xyz.min(axis=0)
        self.aabb_max = xyz.max(axis=0)
        self._center = (self.aabb_min + self.aabb_max) / 2.0
        self._size = float(np.linalg.norm(self.aabb_max - self.aabb_min))
        self._lock = threading.Lock()

    def base_camera(self, width: int, height: int) -> Camera:
        f = width / (2 * math.tan(math.radians(self.fov_deg) / 2))
        # Camera.create takes the world-to-view translation T (camera
        # centre = -R^T T); with R = I and forward = +z, T = d*z - center
        # puts the camera at distance d on the -z side of the scene centre.
        d = 1.2 * max(self._size, 1e-3)
        t = np.array([0.0, 0.0, d]) - self._center
        return Camera.create(np.eye(3, dtype=np.float32), t.astype(np.float32),
                             f, f, width, height, device=self.device)

    def camera_for(self, q: dict, width: int, height: int) -> Camera:
        cam = self.base_camera(width, height)
        yaw = float(q.get("yaw", 0.0))
        pitch = float(q.get("pitch", 0.0))
        roll = float(q.get("roll", 0.0))
        panx = float(q.get("panx", 0.0))
        pany = float(q.get("pany", 0.0))
        zoom = float(q.get("zoom", 0.0))
        if yaw or pitch:
            cam = cam.rotate(yaw, pitch)
        if roll:
            cam = cam.roll(roll)
        if panx or pany:
            cam = cam.translate(panx, pany)
        if zoom:
            cam = cam.zoom(zoom, self.aabb_min, self.aabb_max)
        return cam

    def render_png(self, q: dict) -> bytes:
        width = max(64, min(int(float(q.get("w", self.width))), 1920))
        height = max(64, min(int(float(q.get("h", self.height))), 1440))
        # A handler thread's current CUDA device is the process default;
        # the scene's device is set explicitly.
        on_device = (torch.cuda.device(self.device) if self.device.type == "cuda"
                     else contextlib.nullcontext())
        with self._lock, on_device:   # one device render at a time
            cam = self.camera_for(q, width, height)
            rgb, _, _ = rasterize(self.cloud, cam, background=self.background,
                                  config=self.config, device=self.device)
            arr = (torch.clamp(rgb, 0.0, 1.0) * 255).to(torch.uint8).cpu().numpy()
        return encode_png(arr)

    def state_json(self) -> bytes:
        return json.dumps({
            "num_points": int(self.cloud.num_points),
            "sh_degree": int(self.cloud.sh_degree),
            "aabb_min": [float(v) for v in self.aabb_min],
            "aabb_max": [float(v) for v in self.aabb_max],
        }).encode()


def _make_handler(scene: ViewerScene):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):   # quiet
            pass

        def _send(self, code: int, ctype: str, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            parsed = urlparse(self.path)
            try:
                if parsed.path == "/":
                    self._send(200, "text/html", _PAGE.encode())
                elif parsed.path == "/state":
                    self._send(200, "application/json", scene.state_json())
                elif parsed.path == "/render":
                    q = {k: v[0] for k, v in parse_qs(parsed.query).items()}
                    self._send(200, "image/png", scene.render_png(q))
                else:
                    self._send(404, "text/plain", b"not found")
            except BrokenPipeError:
                pass
            except Exception as e:  # surface render errors to the client
                self._send(500, "text/plain", repr(e).encode())

    return Handler


def serve(
    cloud,
    host: str = "127.0.0.1",
    port: int = 8765,
    device=None,
    **scene_kwargs,
) -> Tuple[ThreadingHTTPServer, ViewerScene]:
    """Start the viewer server (non-blocking), rendering on `device`
    (default `cuda`; it raises without a card). Returns (server, scene);
    call `server.shutdown()` to stop. Use port=0 for an ephemeral port
    (`server.server_address[1]` holds the bound one)."""
    scene = ViewerScene(cloud, device=device, **scene_kwargs)
    server = ThreadingHTTPServer((host, port), _make_handler(scene))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, scene
