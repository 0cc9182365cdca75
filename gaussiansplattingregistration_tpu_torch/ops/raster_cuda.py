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
it runs `composite_tiles_reference`, the kernel's plain-torch twin.

The backward (`composite_tiles_bwd`, the JAX `_bwd_rule`) takes the
cotangents of rgb, alpha and depth and returns d_gT [T, 10, K], the
per-entry gradients of the ten channels. On a CUDA tensor it launches
`csrc/composite_bwd.cu`, which also reads the forward's outputs (saved by
`_CompositeTiles` as residuals: each pixel's total sum (dL/dw) w and the
horizon come from them), and adds one to `composite_tiles_bwd.launches`; on
a CPU tensor it runs `composite_tiles_reference_bwd`. Neither direction
falls back from one route to the other.

Both kernels cull per warp (`csrc/tile_footprint.cuh`): `entry_footprints`
is the box formula of that header and `thread_pixels` its warp layout, in
plain torch, for the tests and for counting the pairs the kernels test;
`footprint_boxes` returns the header's own boxes from the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gaussiansplattingregistration_tpu_torch.utils import profiling

_CHUNK = 128          # horizon unit and twin chunk (the JAX kernel's _CHUNK)
_NCH = 10             # packed param channels (mx,my,conic*3,op,rgb,depth)


def _pixel_centres(ts: int, like: torch.Tensor):
    """Tile-local pixel centres, row-major (p = y*ts + x), each [1, P, 1]."""
    p = torch.arange(ts * ts, device=like.device)
    px = ((p % ts).to(like.dtype) + 0.5)[None, :, None]
    py = ((p // ts).to(like.dtype) + 0.5)[None, :, None]
    return px, py


def _in_count(counts: torch.Tensor, T0: int, K: int, device):
    cnt = counts.reshape(T0).to(torch.int32)
    return cnt, torch.arange(K, device=device)[None, :] < cnt[:, None]   # [T, K]


def _chunk_terms(pc, px, py, in_count, config):
    """One chunk's [T, P, s] terms (dx, dy, sigma, exp_term, raw_alpha,
    alpha), alpha zeroed where invisible or past the tile's count."""
    dx = px - pc[:, None, 0, :]                                    # [T, P, s]
    dy = py - pc[:, None, 1, :]
    ca, cb, cc = pc[:, None, 2, :], pc[:, None, 3, :], pc[:, None, 4, :]
    sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
    exp_term = torch.exp(-torch.clamp_min(sigma, 0.0))
    raw_alpha = pc[:, None, 5, :] * exp_term
    alpha = torch.clamp_max(raw_alpha, config.alpha_max)
    visible = (alpha >= config.alpha_clip) & (sigma >= 0.0) & in_count[:, None, :]
    alpha = torch.where(visible, alpha, 0.0)
    return dx, dy, sigma, exp_term, raw_alpha, alpha


# The culling margin of csrc/tile_footprint.cuh (see its note).
_FOOT_SHRINK = 1e-5   # relative cut of conic a and c
_FOOT_REL = 1e-3      # relative inflation of s_max and the extents
_FOOT_ABS = 1e-3      # absolute inflation (s_max, then px)
_FOOT_MIN_DET = 1e-9  # det / (a c) below this: degenerate


def entry_footprints(gT: torch.Tensor, config) -> torch.Tensor:
    """[T, 4, K] f64 boxes (x0, x1, y0, y1), tile-local, holding every pixel
    centre at which each entry can be visible: the formula of
    `csrc/tile_footprint.cuh::entry_box` with its margin. Empty (x0 > x1)
    where op < alpha_clip; the whole plane for a conic that is not positive
    definite, a non-finite parameter, or alpha_clip <= 0."""
    g = gT.detach().to(torch.float64)
    mx, my, a, b, c, op = (g[:, i, :] for i in range(6))
    clip = float(torch.tensor(config.alpha_clip, dtype=torch.float32))
    finite = torch.isfinite(g[:, :6, :]).all(dim=1) & (clip > 0.0)
    ad, cd = a * (1.0 - _FOOT_SHRINK), c * (1.0 - _FOOT_SHRINK)
    det = ad * cd - b * b
    bounded = (ad > 0) & (cd > 0) & (det > _FOOT_MIN_DET * ad * cd)
    empty = finite & (op < clip)
    box = finite & ~empty & bounded
    s = torch.log(torch.where(box, op, clip) / clip) * (1.0 + _FOOT_REL) + _FOOT_ABS
    det = torch.where(box, det, 1.0)
    hx = torch.sqrt(2.0 * s * torch.where(box, cd, 1.0) / det) * (1.0 + _FOOT_REL) + _FOOT_ABS
    hy = torch.sqrt(2.0 * s * torch.where(box, ad, 1.0) / det) * (1.0 + _FOOT_REL) + _FOOT_ABS
    inf = torch.full_like(mx, float("inf"))
    lo = torch.where(empty, inf, -inf)     # the whole plane where not a box
    out = [torch.where(box, mx - hx, lo), torch.where(box, mx + hx, -lo),
           torch.where(box, my - hy, lo), torch.where(box, my + hy, -lo)]
    return torch.stack(out, dim=1)


def _round_out(v: torch.Tensor, up: bool) -> torch.Tensor:
    """f64 -> f32, rounded toward +inf (`up`) or -inf."""
    f = v.to(torch.float32)
    if up:
        return torch.where(f.double() < v, torch.nextafter(f, torch.tensor(float("inf"))), f)
    return torch.where(f.double() > v, torch.nextafter(f, torch.tensor(float("-inf"))), f)


def footprint_boxes(gT: torch.Tensor, config) -> torch.Tensor:
    """[T, 4, K] f32 culling boxes of the entries of gT, as both kernels
    stage them: on a CUDA tensor from `csrc/tile_footprint.cuh::entry_box`
    (the `entry_boxes` entry point of `csrc/composite_fwd.cu`), on a CPU
    tensor `entry_footprints` with its edges rounded outward to f32, as the
    header rounds them. For checks; not on the render path."""
    if gT.device.type == "cpu":
        b = entry_footprints(gT, config)
        return torch.stack([_round_out(b[:, i], up=bool(i % 2)) for i in range(4)], dim=1)
    if gT.dtype != torch.float32 or gT.ndim != 3 or gT.shape[1] != _NCH:
        raise ValueError(f"gT must be float32 [T, {_NCH}, K], got {gT.dtype} {tuple(gT.shape)}")
    gT = gT.contiguous()
    T0, _, K = gT.shape
    out = torch.empty((T0, K, 4), dtype=torch.float32, device=gT.device)
    with torch.cuda.device(gT.device):
        stream = torch.cuda.current_stream(gT.device).cuda_stream
        err = _boxes_entry()(gT.data_ptr(), T0, K, config.alpha_clip, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"entry_boxes launch failed: cudaError {err}")
    return out.permute(0, 2, 1)


def thread_pixels(ts: int) -> torch.Tensor:
    """Row-major pixel index of each kernel thread (-1 where a lane of the
    last warp holds no pixel): the warp layout of csrc/tile_footprint.cuh,
    8x4 pixel blocks where ts is a multiple of 8, else runs of 32."""
    P = ts * ts
    t = torch.arange(-(-P // 32) * 32)
    if ts % 8 == 0:
        warp, lane = t // 32, t % 32
        p = ((warp // (ts // 8)) * 4 + lane // 8) * ts + (warp % (ts // 8)) * 8 + lane % 8
    else:
        p = t
    return torch.where(t < P, p, -1)


def warp_candidates(boxes: torch.Tensor, ts: int) -> torch.Tensor:
    """[T, P, K] bool: entry k is on the list of pixel p's warp (its box
    meets the box of the warp's pixel centres), for boxes [T, 4, K] from
    `entry_footprints`."""
    tp = thread_pixels(ts)
    warp_of = torch.empty(ts * ts, dtype=torch.long)
    warp_of[tp[tp >= 0]] = torch.nonzero(tp >= 0)[:, 0] // 32
    cx = (torch.arange(ts * ts) % ts).double() + 0.5
    cy = (torch.arange(ts * ts) // ts).double() + 0.5
    n_warps = int(warp_of.max()) + 1
    wb = torch.stack([torch.stack([cx[warp_of == w].min(), cx[warp_of == w].max(),
                                   cy[warp_of == w].min(), cy[warp_of == w].max()])
                      for w in range(n_warps)]).to(boxes.device)        # [W, 4]
    x0, x1, y0, y1 = (boxes[:, None, i, :] for i in range(4))           # [T, 1, K]
    hit = ((x0 <= wb[None, :, 1, None]) & (x1 >= wb[None, :, 0, None])
           & (y0 <= wb[None, :, 3, None]) & (y1 >= wb[None, :, 2, None]))  # [T, W, K]
    return hit[:, warp_of.to(boxes.device), :]


def _value_rows(pc):
    """[T, 5, s] value rows (r, g, b, depth, ones) of a chunk."""
    return torch.cat([pc[:, 6:10, :], torch.ones_like(pc[:, :1, :])], dim=1)


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
    px, py = _pixel_centres(ts, gT)
    cnt, in_count = _in_count(counts, T0, K, gT.device)

    carry = torch.ones((T0, P), dtype=gT.dtype, device=gT.device)
    acc = torch.zeros((T0, P, 5), dtype=gT.dtype, device=gT.device)
    live = torch.zeros((T0,), dtype=gT.dtype, device=gT.device)
    for c0 in range(0, K, S):
        # Chunk-granular horizon: some pixel alive at the chunk's start, and
        # the chunk within the occupied prefix.
        alive = (carry.amax(dim=1) > tmin) & (cnt > c0)
        live = live + torch.where(alive, float(S), 0.0)

        pc = gT[:, :, c0:c0 + S]                                   # [T, 10, s]
        alpha = _chunk_terms(pc, px, py, in_count[:, c0:c0 + S], config)[5]
        lt = torch.log1p(-alpha)
        cum = torch.cumsum(lt, dim=2)
        T = carry[:, :, None] * torch.exp(cum - lt)                # exclusive
        w = torch.where(T > tmin, alpha * T, 0.0)
        acc = acc + torch.einsum("tps,tvs->tpv", w, _value_rows(pc))   # [T, P, 5]
        carry = carry * torch.exp(cum[:, :, -1])
    return (acc[..., 0:3].contiguous(), acc[..., 4].contiguous(),
            acc[..., 3].contiguous(), live)


def composite_tiles_reference_bwd(gT, counts, g_rgb, g_alpha, g_depth, ts: int, config):
    """Plain-torch twin of the backward kernel: the VJP of
    `composite_tiles_reference` with respect to gT, following the JAX
    `_bwd_kernel`'s math, chunked by 128 entries.

    With T_k the exclusive transmittance, w_k = alpha_k T_k where T_k > tmin,
    dL/dw_k = g_rgb . c_k + g_depth d_k + g_alpha and the suffix
    S_k = sum_{j>k} (dL/dw_j) w_j (within the chunk plus every later chunk's
    total, as the JAX kernel carries it):

        dL/dalpha_k = T_k dL/dw_k - S_k / max(1 - alpha_k, 1e-6)

    on live entries with alpha > 0. The gradient passes the alpha_max clamp
    only where raw_alpha < alpha_max and the sigma mask only where sigma > 0;
    sums over the tile's pixels give the ten per-entry channels. Slots past
    counts[t] get zeros. Cotangents: g_rgb [T, P, 3], g_alpha and g_depth
    [T, P]. Returns d_gT [T, 10, K]."""
    T0, nch, K = gT.shape
    if nch != _NCH:
        raise ValueError(f"gT must be [T, {_NCH}, K], got {tuple(gT.shape)}")
    P = ts * ts
    S = _CHUNK
    tmin = config.transmittance_min
    px, py = _pixel_centres(ts, gT)
    _, in_count = _in_count(counts, T0, K, gT.device)
    G5 = torch.cat([g_rgb, g_depth[..., None], g_alpha[..., None]], dim=-1)  # [T, P, 5]

    def chunk(c0, carry):
        pc = gT[:, :, c0:c0 + S]
        terms = _chunk_terms(pc, px, py, in_count[:, c0:c0 + S], config)
        alpha = terms[5]
        lt = torch.log1p(-alpha)
        cum = torch.cumsum(lt, dim=2)
        T = carry[:, :, None] * torch.exp(cum - lt)                # exclusive
        live = T > tmin
        w = torch.where(live, alpha * T, 0.0)
        dldw = torch.einsum("tpv,tvs->tps", G5, _value_rows(pc))   # [T, P, s]
        return pc, terms, T, live, w, dldw, carry * torch.exp(cum[:, :, -1])

    # Sweep 1: each chunk's entry carry and its total of dL/dw * w.
    starts = list(range(0, K, S))
    carries = [torch.ones((T0, P), dtype=gT.dtype, device=gT.device)]
    totals = []
    for c0 in starts:
        _, _, _, _, w, dldw, nxt = chunk(c0, carries[-1])
        totals.append(torch.sum(dldw * w, dim=2))
        carries.append(nxt)
    # Sweep 2, back to front: the suffix of later chunks, then the gradients.
    later = torch.zeros((T0, P), dtype=gT.dtype, device=gT.device)
    out = []
    for i in reversed(range(len(starts))):
        pc, (dx, dy, sigma, exp_term, raw_alpha, alpha), T, live, w, dldw, _ = chunk(
            starts[i], carries[i])
        dw_w = dldw * w
        sfx_incl = torch.flip(torch.cumsum(torch.flip(dw_w, [2]), dim=2), [2])
        S_excl = sfx_incl - dw_w + later[:, :, None]
        dlda = torch.where(live & (alpha > 0.0),
                           T * dldw - S_excl / torch.clamp_min(1.0 - alpha, 1e-6), 0.0)
        dldraw = torch.where(raw_alpha < config.alpha_max, dlda, 0.0)
        dldsigma = torch.where(sigma > 0.0, -dldraw * raw_alpha, 0.0)
        ca, cb, cc = pc[:, None, 2, :], pc[:, None, 3, :], pc[:, None, 4, :]
        grads = [
            -torch.sum(dldsigma * (ca * dx + cb * dy), dim=1),     # mx
            -torch.sum(dldsigma * (cc * dy + cb * dx), dim=1),     # my
            0.5 * torch.sum(dldsigma * dx * dx, dim=1),            # conic a
            torch.sum(dldsigma * dx * dy, dim=1),                  # conic b
            0.5 * torch.sum(dldsigma * dy * dy, dim=1),            # conic c
            torch.sum(dldraw * exp_term, dim=1),                   # opacity
        ]
        color = torch.einsum("tpc,tps->tcs", g_rgb, w)             # r, g, b
        depth = torch.einsum("tp,tps->ts", g_depth, w)
        out.append(torch.cat([torch.stack(grads, dim=1), color, depth[:, None]], dim=1))
        later = later + totals[i]
    return torch.cat(out[::-1], dim=2)


# Both C entry points take gT, counts, T, K, ts, alpha_clip, alpha_max,
# tmin, then their buffers and the stream: the forward's four outputs; the
# backward's three cotangents, the forward's four outputs and d_gT.
_N_POINTERS = {"composite_fwd": 5, "composite_bwd": 9}


@functools.cache
def _kernel(name: str):
    """The built kernel's C entry point (builds it on first use)."""
    from gaussiansplattingregistration_tpu_torch.ops import _build

    fn = getattr(_build.library(name), name)
    p = ctypes.c_void_p
    fn.argtypes = ([p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_float, ctypes.c_float, ctypes.c_float]
                   + [p] * _N_POINTERS[name])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _boxes_entry():
    """The C entry point `entry_boxes` of composite_fwd's library."""
    from gaussiansplattingregistration_tpu_torch.ops import _build

    fn = _build.library("composite_fwd").entry_boxes
    p = ctypes.c_void_p
    fn.argtypes = [p, ctypes.c_int, ctypes.c_int, ctypes.c_float, p, p]
    fn.restype = ctypes.c_int
    return fn


def _check_inputs(gT: torch.Tensor, counts: torch.Tensor, ts: int):
    """Validate the kernels' shared inputs; returns counts as int32 [T]."""
    if gT.device.type != "cuda":
        raise ValueError(f"composite kernel needs a CUDA tensor, got {gT.device}")
    if gT.dtype != torch.float32 or not gT.is_contiguous():
        raise ValueError("gT must be contiguous float32")
    if gT.ndim != 3 or gT.shape[1] != _NCH:
        raise ValueError(f"gT must be [T, {_NCH}, K], got {tuple(gT.shape)}")
    T0 = gT.shape[0]
    if counts.device != gT.device or counts.numel() != T0:
        raise ValueError(f"counts must hold {T0} values on {gT.device}")
    if not 1 <= ts * ts <= 1024:
        raise ValueError(f"tile_size {ts}: ts*ts must be in [1, 1024] threads")
    return counts.reshape(T0).to(torch.int32).contiguous()


def _call(name: str, gT, cnt, ts: int, config, *ptrs) -> None:
    T0, _, K = gT.shape
    with torch.cuda.device(gT.device):
        stream = torch.cuda.current_stream(gT.device).cuda_stream
        err = _kernel(name)(gT.data_ptr(), cnt.data_ptr(), T0, K, ts,
                            config.alpha_clip, config.alpha_max,
                            config.transmittance_min, *ptrs, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _launch(gT: torch.Tensor, counts: torch.Tensor, ts: int, config):
    cnt = _check_inputs(gT, counts, ts)
    T0, P = gT.shape[0], ts * ts
    rgb = torch.empty((T0, P, 3), dtype=torch.float32, device=gT.device)
    alpha = torch.empty((T0, P), dtype=torch.float32, device=gT.device)
    depth = torch.empty((T0, P), dtype=torch.float32, device=gT.device)
    live = torch.empty((T0,), dtype=torch.float32, device=gT.device)
    _call("composite_fwd", gT, cnt, ts, config,
          rgb.data_ptr(), alpha.data_ptr(), depth.data_ptr(), live.data_ptr())
    composite_tiles.launches += 1
    return rgb, alpha, depth, live


def _launch_bwd(gT, counts, g_rgb, g_alpha, g_depth, ts: int, config, fwd_out):
    cnt = _check_inputs(gT, counts, ts)
    T0, P = gT.shape[0], ts * ts
    bufs = []
    for name, t, shape in (("g_rgb", g_rgb, (T0, P, 3)), ("g_alpha", g_alpha, (T0, P)),
                           ("g_depth", g_depth, (T0, P)), ("rgb", fwd_out[0], (T0, P, 3)),
                           ("alpha", fwd_out[1], (T0, P)), ("depth", fwd_out[2], (T0, P)),
                           ("live", fwd_out[3], (T0,))):
        if t.device != gT.device or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} on {gT.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
        bufs.append(t.to(torch.float32).contiguous())
    # The kernel writes every slot of d_gT, zeros past each tile's horizon.
    d_gT = torch.empty_like(gT)
    _call("composite_bwd", gT, cnt, ts, config,
          *(b.data_ptr() for b in bufs), d_gT.data_ptr())
    composite_tiles_bwd.launches += 1
    return d_gT


def composite_tiles_bwd(gT, counts, g_rgb, g_alpha, g_depth, ts: int, config, fwd_out):
    """d_gT [T, 10, K] of the compositor for the cotangents of (rgb, alpha,
    depth): the kernel on a CUDA tensor, its twin on a CPU tensor. `fwd_out`
    is the forward's (rgb, alpha, depth, live) on these inputs, which the
    kernel reads; the twin recomputes what it needs."""
    if gT.device.type == "cpu":
        return composite_tiles_reference_bwd(gT, counts, g_rgb, g_alpha, g_depth, ts, config)
    return _launch_bwd(gT, counts, g_rgb, g_alpha, g_depth, ts, config, fwd_out)


class _CompositeTiles(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gT, counts, ts, config):
        with profiling.span("raster.composite"):
            if gT.device.type == "cpu":
                outs = composite_tiles_reference(gT, counts, ts, config)
            else:
                outs = _launch(gT, counts, ts, config)
        ctx.mark_non_differentiable(outs[3])
        # Residuals: (gT, counts), as the JAX `_fwd_rule`'s, and the outputs,
        # from which the backward kernel reads each pixel's total and each
        # tile's horizon instead of recomputing them.
        ctx.save_for_backward(gT, counts, *outs)
        ctx.ts, ctx.config = ts, config
        ctx.request = profiling.request_id()
        return outs

    @staticmethod
    def backward(ctx, g_rgb, g_alpha, g_depth, _g_live):
        with profiling.span("raster.composite_vjp", request=ctx.request):
            gT, counts, *outs = ctx.saved_tensors
            d_gT = composite_tiles_bwd(gT, counts, g_rgb, g_alpha, g_depth, ctx.ts, ctx.config,
                                       fwd_out=outs)
        return d_gT, None, None, None


def composite_tiles(gT: torch.Tensor, counts: torch.Tensor, ts: int, config):
    """Per-tile front-to-back compositing (see the module docstring)."""
    return _CompositeTiles.apply(gT, counts, ts, config)


composite_tiles.launches = 0
composite_tiles_bwd.launches = 0
