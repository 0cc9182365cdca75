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
`csrc/composite_bwd.cu` and adds one to `composite_tiles_bwd.launches`; on a
CPU tensor it runs `composite_tiles_reference_bwd`. Neither direction falls
back from one route to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

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
# tmin, then four buffers (the forward's outputs, or the backward's three
# cotangents and d_gT) and the stream.
_N_POINTERS = 5


@functools.cache
def _kernel(name: str):
    """The built kernel's C entry point (builds it on first use)."""
    from gaussiansplattingregistration_tpu_torch.ops import _build

    fn = getattr(_build.library(name), name)
    p = ctypes.c_void_p
    fn.argtypes = ([p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_float, ctypes.c_float, ctypes.c_float]
                   + [p] * _N_POINTERS)
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


def _launch_bwd(gT, counts, g_rgb, g_alpha, g_depth, ts: int, config):
    cnt = _check_inputs(gT, counts, ts)
    T0, P = gT.shape[0], ts * ts
    cts = []
    for name, ct, shape in (("g_rgb", g_rgb, (T0, P, 3)), ("g_alpha", g_alpha, (T0, P)),
                            ("g_depth", g_depth, (T0, P))):
        if ct.device != gT.device or tuple(ct.shape) != shape:
            raise ValueError(f"{name} must be {shape} on {gT.device}, got "
                             f"{tuple(ct.shape)} on {ct.device}")
        cts.append(ct.to(torch.float32).contiguous())
    # The kernel writes every slot of d_gT, zeros past each tile's horizon.
    d_gT = torch.empty_like(gT)
    _call("composite_bwd", gT, cnt, ts, config,
          *(ct.data_ptr() for ct in cts), d_gT.data_ptr())
    composite_tiles_bwd.launches += 1
    return d_gT


def composite_tiles_bwd(gT, counts, g_rgb, g_alpha, g_depth, ts: int, config):
    """d_gT [T, 10, K] of the compositor for the cotangents of (rgb, alpha,
    depth): the kernel on a CUDA tensor, its twin on a CPU tensor."""
    if gT.device.type == "cpu":
        return composite_tiles_reference_bwd(gT, counts, g_rgb, g_alpha, g_depth, ts, config)
    return _launch_bwd(gT, counts, g_rgb, g_alpha, g_depth, ts, config)


class _CompositeTiles(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gT, counts, ts, config):
        if gT.device.type == "cpu":
            outs = composite_tiles_reference(gT, counts, ts, config)
        else:
            outs = _launch(gT, counts, ts, config)
        ctx.mark_non_differentiable(outs[3])
        # Residuals are (gT, counts) only, as the JAX `_fwd_rule`'s: the
        # backward recomputes the transmittance.
        ctx.save_for_backward(gT, counts)
        ctx.ts, ctx.config = ts, config
        return outs

    @staticmethod
    def backward(ctx, g_rgb, g_alpha, g_depth, _g_live):
        gT, counts = ctx.saved_tensors
        d_gT = composite_tiles_bwd(gT, counts, g_rgb, g_alpha, g_depth, ctx.ts, ctx.config)
        return d_gT, None, None, None


def composite_tiles(gT: torch.Tensor, counts: torch.Tensor, ts: int, config):
    """Per-tile front-to-back compositing (see the module docstring)."""
    return _CompositeTiles.apply(gT, counts, ts, config)


composite_tiles.launches = 0
composite_tiles_bwd.launches = 0
