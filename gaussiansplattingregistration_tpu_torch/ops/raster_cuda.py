"""CUDA tile compositor: counterpart of `ops/raster_pallas.py` in the JAX package.

`composite_tiles` has the inputs and outputs of `composite_tiles_pallas`:

    gT      [T, 10, K] f32 channel-major entry params (mx, my tile-local,
            conic a/b/c, opacity, r, g, b, depth)
    counts  [T, 1] occupied-prefix length of each tile row
    ->      rgb [T, P, 3], alpha [T, P], depth [T, P], live [T] f32

with P = ts*ts row-major pixels and `live` each tile's early-termination
horizon in entries, counted in whole 128-entry chunks (so it can exceed K).
Entries at k >= counts[t] are not composited; the gather that builds gT
gives them zero opacity, so the JAX kernel, which reads them, agrees.

On a CUDA tensor it launches `csrc/composite_fwd.cu` (built at first use,
see `_build.py`) and adds one to `composite_tiles.launches`; on a CPU tensor
it runs `composite_tiles_reference`, the kernel's plain-torch twin. There is
no fallback from one to the other. The backward is the next port slice: it
raises rather than return wrong gradients.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_CHUNK = 128          # horizon unit and twin chunk (the JAX kernel's _CHUNK)
_NCH = 10             # packed param channels (mx,my,conic*3,op,rgb,depth)


def composite_tiles_reference(gT: torch.Tensor, counts: torch.Tensor, ts: int, config):
    """Plain-torch twin of the CUDA kernel, following the JAX kernel's math:
    per 128-entry chunk an exclusive log1p/cumsum/exp transmittance with a
    carried T, the same alpha_clip / alpha_max / sigma masks, and the same
    chunk-granular live horizon."""
    T0, nch, K = gT.shape
    if nch != _NCH:
        raise ValueError(f"gT must be [T, {_NCH}, K], got {tuple(gT.shape)}")
    P = ts * ts
    S = _CHUNK
    tmin = config.transmittance_min
    # Tile-local pixel centres, row-major (p = y*ts + x), as [1, P, 1].
    p = torch.arange(P, device=gT.device)
    px = ((p % ts).to(gT.dtype) + 0.5)[None, :, None]
    py = ((p // ts).to(gT.dtype) + 0.5)[None, :, None]
    cnt = counts.reshape(T0).to(torch.int32)
    in_count = torch.arange(K, device=gT.device)[None, :] < cnt[:, None]   # [T, K]

    carry = torch.ones((T0, P), dtype=gT.dtype, device=gT.device)
    acc = torch.zeros((T0, P, 5), dtype=gT.dtype, device=gT.device)
    live = torch.zeros((T0,), dtype=gT.dtype, device=gT.device)
    for c0 in range(0, K, S):
        # Chunk-granular horizon: some pixel alive at the chunk's start, and
        # the chunk within the occupied prefix.
        alive = (carry.amax(dim=1) > tmin) & (cnt > c0)
        live = live + torch.where(alive, float(S), 0.0)

        pc = gT[:, :, c0:c0 + S]                                   # [T, 10, s]
        dx = px - pc[:, None, 0, :]                                # [T, P, s]
        dy = py - pc[:, None, 1, :]
        ca, cb, cc = pc[:, None, 2, :], pc[:, None, 3, :], pc[:, None, 4, :]
        sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
        alpha = torch.clamp_max(
            pc[:, None, 5, :] * torch.exp(-torch.clamp_min(sigma, 0.0)),
            config.alpha_max,
        )
        visible = ((alpha >= config.alpha_clip) & (sigma >= 0.0)
                   & in_count[:, None, c0:c0 + S])
        alpha = torch.where(visible, alpha, 0.0)

        lt = torch.log1p(-alpha)
        cum = torch.cumsum(lt, dim=2)
        T = carry[:, :, None] * torch.exp(cum - lt)                # exclusive
        w = torch.where(T > tmin, alpha * T, 0.0)
        vals = torch.cat([pc[:, 6:10, :], torch.ones_like(pc[:, :1, :])], dim=1)
        acc = acc + torch.einsum("tps,tvs->tpv", w, vals)          # [T, P, 5]
        carry = carry * torch.exp(cum[:, :, -1])
    return (acc[..., 0:3].contiguous(), acc[..., 4].contiguous(),
            acc[..., 3].contiguous(), live)


@functools.cache
def _kernel():
    """The built kernel's C entry point (builds it on first use)."""
    from gaussiansplattingregistration_tpu_torch.ops import _build

    fn = _build.library("composite_fwd").composite_fwd
    p = ctypes.c_void_p
    fn.argtypes = [p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_float, ctypes.c_float,
                   p, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def _launch(gT: torch.Tensor, counts: torch.Tensor, ts: int, config):
    if gT.device.type != "cuda":
        raise ValueError(f"composite kernel needs a CUDA tensor, got {gT.device}")
    if gT.dtype != torch.float32 or not gT.is_contiguous():
        raise ValueError("gT must be contiguous float32")
    if gT.ndim != 3 or gT.shape[1] != _NCH:
        raise ValueError(f"gT must be [T, {_NCH}, K], got {tuple(gT.shape)}")
    T0, _, K = gT.shape
    if counts.device != gT.device or counts.numel() != T0:
        raise ValueError(f"counts must hold {T0} values on {gT.device}")
    if not 1 <= ts * ts <= 1024:
        raise ValueError(f"tile_size {ts}: ts*ts must be in [1, 1024] threads")
    P = ts * ts
    cnt = counts.reshape(T0).to(torch.int32).contiguous()
    rgb = torch.empty((T0, P, 3), dtype=torch.float32, device=gT.device)
    alpha = torch.empty((T0, P), dtype=torch.float32, device=gT.device)
    depth = torch.empty((T0, P), dtype=torch.float32, device=gT.device)
    live = torch.empty((T0,), dtype=torch.float32, device=gT.device)
    fn = _kernel()
    with torch.cuda.device(gT.device):
        stream = torch.cuda.current_stream(gT.device).cuda_stream
        err = fn(gT.data_ptr(), cnt.data_ptr(), T0, K, ts,
                 config.alpha_clip, config.alpha_max, config.transmittance_min,
                 rgb.data_ptr(), alpha.data_ptr(), depth.data_ptr(),
                 live.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"composite_fwd launch failed: cudaError {err}")
    composite_tiles.launches += 1
    return rgb, alpha, depth, live


class _CompositeTiles(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gT, counts, ts, config):
        if gT.device.type == "cpu":
            outs = composite_tiles_reference(gT, counts, ts, config)
        else:
            outs = _launch(gT, counts, ts, config)
        ctx.mark_non_differentiable(outs[3])
        return outs

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("composite backward: ROADMAP slice 2")


def composite_tiles(gT: torch.Tensor, counts: torch.Tensor, ts: int, config):
    """Per-tile front-to-back compositing (see the module docstring)."""
    return _CompositeTiles.apply(gT, counts, ts, config)


composite_tiles.launches = 0
