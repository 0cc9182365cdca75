"""Nearest-neighbor search: blocked brute-force sweeps and a 27-cell grid.

Torch counterpart of `gaussiansplattingregistration_tpu/ops/knn.py`, with the
same names, the same results and the same tie order where the reduction
defines one (`min` and `argmin` keep the first minimum, as JAX's do).

Distances for D <= 4 are summed per coordinate, (q_i - d_j)^2, never by the
Gram trick |q|^2 + |d|^2 - 2 q.d: that is a matmul whose cancellation
swamps the distance between close points (and `torch.cdist` takes that route
in its default compute mode). For D > 4 the Gram form runs as a float32
matmul; the package turns TF32 off at import, so it is not rounded to TF32.

On a CUDA float32 query and data of D <= 4 coordinates with
1 <= k <= min(N, `KERNEL_MAX_K`) and at least one query (every D = 3
caller: k = 1 for ICP, 20, 30 and 32 for GICP, normals and HEM, FPFH's
`max_nn`), `knn`, `hybrid_search` and `nearest_neighbor` launch
`knn_brute`, the hand-written sweep of `csrc/knn_brute.cu`: the same
distances, bit for bit, and the k nearest selected in the same pass, with
no [Q, N] tensor in device memory. Its results come out ascending by
(d2, index) as one key, so exact ties are ordered by index (for k = 1 the
first index wins, as `torch.min`'s rule). Every other input takes the plain
form below (`_knn_blocked`, `_nearest_blocked`): a CPU tensor, the Gram
form of D > 4 (FPFH feature matching), k > `KERNEL_MAX_K`, an empty query
or k > N (which keep the plain form's empty outputs and its error). The
rule reads the inputs' device, dtype and shapes only.

The plain form processes queries in blocks chosen so that each [B, N]
float32 temporary stays within `BLOCK_BYTES` (256 MB): at 100k x 100k an
unblocked tile would take 40 GB. The JAX package blocks by a fixed
`block_size` for its compiler; the torch functions keep the keyword, and
take the budget's block when it is None; the kernel needs no block.

Every function runs on the device of its inputs.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from gaussiansplattingregistration_tpu_torch.utils import profiling

BLOCK_BYTES = 256 << 20
KERNEL_MAX_K = 128        # the largest k of csrc/knn_brute.cu's k-list
_GRID_PAD_COORD = 1.0e9   # empty-slot coordinate: d2 ~ 1e18, never in gate


def _rows_per_block(n_data: int, block_size: Optional[int]) -> int:
    if block_size is not None:
        return max(1, int(block_size))
    return max(1, BLOCK_BYTES // (4 * max(n_data, 1)))


def _pairwise_sqdist(q: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """[B, D] x [N, D] -> [B, N] squared distances; see the module docstring
    for the two forms. The difference form adds the coordinates in order,
    ((x^2 + y^2) + z^2), as the JAX function does."""
    if q.shape[-1] <= 4:
        acc = None
        for c in range(q.shape[-1]):
            term = torch.sub(q[:, c:c + 1], d[None, :, c]).square_()
            acc = term if acc is None else acc.add_(term)
        return acc
    q2 = torch.sum(q * q, dim=-1, keepdim=True)
    d2 = torch.sum(d * d, dim=-1)[None, :]
    return torch.clamp_min(q2 + d2 - 2.0 * (q @ d.T), 0.0)


def knn(
    query: torch.Tensor,
    data: torch.Tensor,
    k: int,
    block_size: Optional[int] = None,
    approx: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest neighbors of each query point in `data`.

    Returns (sq_distances [Q, k], indices [Q, k] int64), sorted ascending by
    distance. The selection is always exact: `approx=True` (the JAX
    package's `approx_max_k` on TPU, recall ~0.975) is accepted and ignored.
    On the CPU the JAX function is exact too, so the two agree there. The
    order of exactly tied distances is by index where the kernel runs
    (see the module docstring), else torch.topk's, and may differ from
    JAX's."""
    del approx
    with profiling.span("knn.knn"):
        profiling.count("knn.pairs", query.shape[0] * data.shape[0])
        return _knn(query, data, k, block_size)


def _takes_kernel(query: torch.Tensor, data: torch.Tensor, k: int) -> bool:
    """Whether a brute search of `query` in `data` for k neighbors runs on
    `knn_brute`: float32 [Q, D] and [N, D] on one CUDA device, D <= 4,
    Q >= 1 and 1 <= k <= min(N, KERNEL_MAX_K). Anything else keeps the
    plain form, and with it the plain form's results and errors (an empty
    query gives empty outputs, k > N raises in `torch.topk`)."""
    return (query.device.type == "cuda" and data.device == query.device
            and query.dtype == torch.float32 and data.dtype == torch.float32
            and len(query.shape) == 2 and len(data.shape) == 2
            and query.shape[1] == data.shape[1] <= 4 and query.shape[0] >= 1
            and 1 <= k <= min(data.shape[0], KERNEL_MAX_K))


def _knn(query, data, k, block_size):
    if _takes_kernel(query, data, k):
        return knn_brute(query.contiguous(), data.contiguous(), k)
    return _knn_blocked(query, data, k, block_size)


def _knn_blocked(query, data, k, block_size):
    """The plain form of `knn`: blocked [B, N] distances, then torch.topk."""
    rows = _rows_per_block(data.shape[0], block_size)
    d2s, idxs = [], []
    for q0 in range(0, query.shape[0], rows):
        d2 = _pairwise_sqdist(query[q0:q0 + rows], data)
        v, i = torch.topk(d2, k, dim=1, largest=False, sorted=True)
        d2s.append(v)
        idxs.append(i)
    if not d2s:
        return (query.new_zeros((0, k)),
                torch.zeros((0, k), dtype=torch.int64, device=query.device))
    return torch.cat(d2s), torch.cat(idxs)


def hybrid_search(
    query: torch.Tensor,
    data: torch.Tensor,
    radius: float,
    k: int,
    block_size: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """KDTreeSearchParamHybrid analogue: k nearest within `radius`.
    Returns (sq_distances [Q, k], indices [Q, k], valid_mask [Q, k])."""
    with profiling.span("knn.hybrid"):
        profiling.count("knn.pairs", query.shape[0] * data.shape[0])
        d2, idx = _knn(query, data, k, block_size)
        return d2, idx, d2 <= radius * radius


def nearest_neighbor(
    query: torch.Tensor, data: torch.Tensor, block_size: Optional[int] = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single nearest neighbor: (sq_distance [Q], index [Q] int64); ties
    keep the first index."""
    with profiling.span("knn.nearest"):
        profiling.count("knn.pairs", query.shape[0] * data.shape[0])
        if _takes_kernel(query, data, 1):
            d2, idx = knn_brute(query.contiguous(), data.contiguous(), 1)
            return d2[:, 0], idx[:, 0]
        return _nearest_blocked(query, data, block_size)


def _nearest_blocked(query, data, block_size):
    """The plain form of `nearest_neighbor`: one `min` over each [B, N]
    tile gives both outputs."""
    rows = _rows_per_block(data.shape[0], block_size)
    d2s, idxs = [], []
    for q0 in range(0, query.shape[0], rows):
        v, i = torch.min(_pairwise_sqdist(query[q0:q0 + rows], data), dim=1)
        d2s.append(v)
        idxs.append(i)
    if not d2s:
        return (query.new_zeros((0,)),
                torch.zeros((0,), dtype=torch.int64, device=query.device))
    return torch.cat(d2s), torch.cat(idxs)


# csrc/knn_brute.cu's kThreads, kRows, kChunk and kMaxSplits.
_THREADS, _ROWS, _CHUNK, _MAX_SPLITS = 128, 4, 512, 64


@functools.cache
def _entry(name: str):
    """A C entry point of csrc/knn_brute.cu (built on first use)."""
    from gaussiansplattingregistration_tpu_torch.ops import _build

    fn = getattr(_build.library("knn_brute"), name)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i] if name == "knn_brute_blocks_per_sm" else [p, p, i, i, i, i, i] + [p] * 5
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _wave(device: int, k: int) -> int:
    """The sweep's blocks that the card runs at once for k: its SMs times
    the kernel's blocks an SM. Asked of the card once per device and k;
    the first ask also allows the k-list kernel its shared memory there."""
    with torch.cuda.device(device):
        per_sm = _entry("knn_brute_blocks_per_sm")(k)
    if per_sm < 1:
        raise RuntimeError(f"knn_brute_blocks_per_sm({k}) failed: cudaError {-per_sm}")
    return per_sm * torch.cuda.get_device_properties(device).multi_processor_count


def _splits(n_query: int, n_data: int, k: int, wave: int) -> int:
    """The ranges of the data the sweep splits into: enough blocks for one
    full wave where the queries alone would leave SMs idle, at least one
    staged chunk a range, at most `_MAX_SPLITS`."""
    rows = _THREADS * _ROWS if k == 1 else _THREADS
    blocks = -(-n_query // rows)
    return max(1, min(wave // max(blocks, 1), n_data // _CHUNK, _MAX_SPLITS))


def knn_brute(query: torch.Tensor, data: torch.Tensor, k: int):
    """The k nearest rows of `data` to each row of `query` by the kernel of
    `csrc/knn_brute.cu`: (sq_distances [Q, k] float32, indices [Q, k]
    int64), ascending by (distance, index). Both inputs contiguous float32
    [Q, D] and [N, D] on one CUDA device, 1 <= D <= 4, and
    1 <= k <= min(N, KERNEL_MAX_K) (any k for Q = 0, which returns empty
    outputs and launches nothing); raises on anything else. One call into
    the library a search: launches on the current stream and reads nothing
    back; adds one to `knn_brute.launches` and Q·N to the counter
    `knn.kernel_pairs`."""
    inputs = (("query", query), ("data", data))
    for name, x in inputs:
        if x.dtype != torch.float32:
            raise ValueError(f"knn_brute: {name} must be float32, got {x.dtype}")
    for name, x in inputs:
        if x.ndim != 2 or not 1 <= x.shape[1] <= 4 or x.shape[0] >= 1 << 30:
            raise ValueError(f"knn_brute: {name} must be [rows, 1..4] with rows < 2^30, "
                             f"got {tuple(x.shape)}")
    for name, x in inputs:
        if not x.is_contiguous():
            raise ValueError(f"knn_brute: {name} must be contiguous")
    for name, x in inputs:
        if x.device.type != "cuda":
            raise ValueError(f"knn_brute needs CUDA tensors, got {name} on {x.device}")
    if data.device != query.device or data.shape[1] != query.shape[1]:
        raise ValueError(f"knn_brute: query {tuple(query.shape)} on {query.device} and data "
                         f"{tuple(data.shape)} on {data.device} do not match")
    n_query, n_data, dim = query.shape[0], data.shape[0], query.shape[1]
    dev = query.device
    d2 = torch.empty((n_query, k), dtype=torch.float32, device=dev)
    idx = torch.empty((n_query, k), dtype=torch.int64, device=dev)
    if n_query == 0:
        return d2, idx
    if not 1 <= k <= min(n_data, KERNEL_MAX_K):
        raise ValueError(f"knn_brute: k={k} outside [1, min({n_data}, {KERNEL_MAX_K})]")
    with torch.cuda.device(dev):
        splits = _splits(n_query, n_data, k, _wave(dev.index, k))
        # Partial lists of the split sweep, [2, splits, Q, k] of 32 bits.
        part = (torch.empty((2, splits, n_query, k), dtype=torch.int32, device=dev)
                if k > 1 and splits > 1 else None)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry("knn_brute")(query.data_ptr(), data.data_ptr(), n_query, n_data, dim, k,
                                  splits, d2.data_ptr(), idx.data_ptr(),
                                  None if part is None else part[0].data_ptr(),
                                  None if part is None else part[1].data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"knn_brute launch failed: cudaError {err}")
    knn_brute.launches += 1
    profiling.count("knn.kernel_pairs", n_query * n_data)
    return d2, idx


knn_brute.launches = 0


# --------------------------------------------------------------------------
# Grid-pruned gated nearest neighbor. ICP only needs the nearest neighbor
# WITHIN max_correspondence: any true match lies in the query's 3x3x3 cell
# neighborhood once cell >= gate. Per cell, one padded row holds every point
# of its 27-cell neighborhood as (x, y, z, index), so a correspondence step
# is one row gather [Q rows] plus a [Q, W] masked min, instead of a [Q, N]
# sweep. The plan is host numpy (shape logic only); the table is built on
# the points' device. Degenerate densities return None -> callers keep the
# brute path.
# --------------------------------------------------------------------------


def grid_nn_plan(
    target_np,
    gate: float,
    max_table_mb: float = 512.0,
    max_cells: int = 1_000_000,
    max_w: int = 8192,
):
    """Host-side planning only: (origin [3] f32, inv_cell f32, dims
    (nx, ny, nz), max_occ) or None. Cell size: the smallest power-of-2
    multiple of the gate whose table (n_cells x 27 * max_occ slots x 16 B)
    fits the memory cap. A copy of the JAX package's plan; `target_np` may
    be a tensor."""
    if torch.is_tensor(target_np):
        target_np = target_np.detach().cpu().numpy()
    pts = np.asarray(target_np, np.float32)
    m = pts.shape[0]
    if m == 0 or m >= (1 << 24) or not np.isfinite(pts).all() or gate <= 0:
        return None
    lo = pts.min(axis=0)
    span = pts.max(axis=0) - lo
    cell = float(gate)
    for _ in range(40):
        dims = np.minimum(np.floor(span / cell).astype(np.int64) + 1, 1 << 20)
        n_cells = int(dims.prod())
        # Average occupancy lower-bounds W; coarsening only increases it.
        if 27 * m / max(n_cells, 1) > max_w:
            return None
        if n_cells <= max_cells:
            c = np.floor((pts - lo) / np.float32(cell)).astype(np.int64)
            cx = np.clip(c[:, 0], 0, int(dims[0]) - 1)
            cy = np.clip(c[:, 1], 0, int(dims[1]) - 1)
            cz = np.clip(c[:, 2], 0, int(dims[2]) - 1)
            cid = (cz * dims[1] + cy) * dims[0] + cx
            max_occ = int(np.bincount(cid, minlength=n_cells).max())
            max_occ = -(-max_occ // 8) * 8
            w = 27 * max_occ
            if w <= max_w and n_cells * w * 16 <= max_table_mb * 1e6:
                return (
                    lo.astype(np.float32),
                    np.float32(1.0 / cell),
                    (int(dims[0]), int(dims[1]), int(dims[2])),
                    max_occ,
                )
        cell *= 2.0
    return None


def _cell_ids(points, origin, inv_cell, nx, ny, nz):
    c = torch.floor((points - origin[None, :]) * inv_cell).to(torch.int64)
    cx = torch.clamp(c[:, 0], 0, nx - 1)
    cy = torch.clamp(c[:, 1], 0, ny - 1)
    cz = torch.clamp(c[:, 2], 0, nz - 1)
    return (cz * ny + cy) * nx + cx


def build_grid_table(
    points: torch.Tensor,      # [M, 3]
    valid: torch.Tensor,       # [M] bool: rows to index
    origin,
    inv_cell,
    nx: int, ny: int, nz: int, max_occ: int,
) -> torch.Tensor:
    """27-cell candidate table [n_cells, 27 * max_occ * 4] on the points'
    device. Slot layout per cell: 27 blocks (dz, dy, dx in -1..1, dx
    fastest) of max_occ entries (x, y, z, index) in point order; empty slots
    carry far-away coords and index -1 (the JAX layout, so that a min over a
    row breaks ties as JAX's does)."""
    with profiling.span("knn.grid_table"):
        dev = points.device
        origin = torch.as_tensor(origin, dtype=points.dtype, device=dev)
        inv_cell = float(inv_cell)
        m = points.shape[0]
        n_cells = nx * ny * nz
        cid = _cell_ids(points, origin, inv_cell, nx, ny, nz)
        cid = torch.where(valid.to(dev), cid, torch.full_like(cid, n_cells))
        sorted_cid, order = torch.sort(cid, stable=True)
        starts = torch.searchsorted(sorted_cid, torch.arange(n_cells + 1, device=dev))
        rank = torch.arange(m, device=dev) - starts[sorted_cid]
        in_slot = (rank < max_occ) & (sorted_cid < n_cells)
        idx_cell = torch.full((n_cells * max_occ,), -1, dtype=torch.int64, device=dev)
        idx_cell[(sorted_cid * max_occ + rank)[in_slot]] = order[in_slot]
        idx_cell = idx_cell.reshape(n_cells, max_occ)

        pad_row = torch.tensor([_GRID_PAD_COORD] * 3 + [-1.0], dtype=points.dtype, device=dev)
        safe = idx_cell.clamp_min(0).reshape(-1)
        pts4 = torch.cat([points[safe], safe[:, None].to(points.dtype)], dim=-1)
        pts4 = torch.where((idx_cell < 0).reshape(-1, 1), pad_row[None, :], pts4)
        # The extra row is the all-empty sentinel that out-of-grid neighbors take.
        cell_rows = torch.cat([pts4.reshape(n_cells, max_occ * 4),
                               pad_row.repeat(max_occ)[None, :]])

        cz, cy, cx = torch.meshgrid(torch.arange(nz, device=dev), torch.arange(ny, device=dev),
                                    torch.arange(nx, device=dev), indexing="ij")
        cz, cy, cx = cz.reshape(-1), cy.reshape(-1), cx.reshape(-1)
        blocks = []
        for dz in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    z, y, x = cz + dz, cy + dy, cx + dx
                    ok = (z >= 0) & (z < nz) & (y >= 0) & (y < ny) & (x >= 0) & (x < nx)
                    blocks.append(cell_rows[torch.where(ok, (z * ny + y) * nx + x, n_cells)])
        return torch.cat(blocks, dim=-1)


def _grid_block(n_query: int, w: int) -> int:
    """Queries per block so that the gathered [B, W, 4] slab stays ~256 MB
    (an even split, as the JAX function makes)."""
    cap = max(1024, ((256 << 20) // (w * 16)) // 1024 * 1024)
    n_blocks = max(1, -(-n_query // cap))
    return max(1024, -(-(-(-n_query // n_blocks)) // 1024) * 1024)


def _grid_candidates(qb, table, origin, inv_cell, nx, ny, nz, w):
    """The rows of the queries' cells as [B, W, 4] and their squared
    distances [B, W], summed in the brute form's order."""
    cand = table[_cell_ids(qb, origin, inv_cell, nx, ny, nz)].reshape(qb.shape[0], w, 4)
    d2 = None
    for c in range(3):
        term = torch.sub(cand[:, :, c], qb[:, c:c + 1]).square_()
        d2 = term if d2 is None else d2.add_(term)
    return cand, d2


def grid_nearest_neighbor(
    query: torch.Tensor,       # [Q, 3]
    table: torch.Tensor,       # [n_cells, W*4] from build_grid_table
    origin,
    inv_cell,
    nx: int, ny: int, nz: int, w: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gated nearest neighbor via the 27-cell table: (sq_distance [Q],
    index [Q] int64). Exact for every neighbor within the plan's gate and
    ~1e18 when the neighborhood is empty (callers gate with d2 <= gate^2)."""
    with profiling.span("knn.grid_nearest"):
        profiling.count("knn.pairs", query.shape[0] * w)
        origin = torch.as_tensor(origin, dtype=query.dtype, device=query.device)
        inv_cell = float(inv_cell)
        block = _grid_block(query.shape[0], w)
        d2s, idxs = [], []
        for q0 in range(0, query.shape[0], block):
            cand, d2 = _grid_candidates(query[q0:q0 + block], table, origin, inv_cell,
                                        nx, ny, nz, w)
            dmin, j = torch.min(d2, dim=1)
            idx = torch.gather(cand[:, :, 3], 1, j[:, None])[:, 0]
            d2s.append(dmin)
            idxs.append(idx.clamp_min(0).to(torch.int64))
        if not d2s:
            return (query.new_zeros((0,)),
                    torch.zeros((0,), dtype=torch.int64, device=query.device))
        return torch.cat(d2s), torch.cat(idxs)


def grid_topk(
    query: torch.Tensor,       # [Q, 3]
    table: torch.Tensor,       # [n_cells(+pad), W*4] from build_grid_table
    origin,
    inv_cell,
    dims,                      # (nx, ny, nz)
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest candidates from each query's 27-cell neighborhood:
    (sq_distances [Q, k], indices [Q, k] int64), nearest first. Exact for
    every neighbor within the plan's cell size; slots past a window's
    population carry d2 ~ 1e18 and index 0, which callers' radius gates
    mask."""
    w = table.shape[1] // 4
    with profiling.span("knn.grid_topk"):
        profiling.count("knn.pairs", query.shape[0] * w)
        origin = torch.as_tensor(origin, dtype=query.dtype, device=query.device)
        inv_cell = float(inv_cell)
        nx, ny, nz = (int(v) for v in dims)
        block = _grid_block(query.shape[0], w)
        d2s, idxs = [], []
        for q0 in range(0, query.shape[0], block):
            cand, d2 = _grid_candidates(query[q0:q0 + block], table, origin, inv_cell,
                                        nx, ny, nz, w)
            v, j = torch.topk(d2, k, dim=1, largest=False, sorted=True)
            idx = torch.gather(cand[:, :, 3], 1, j)
            d2s.append(v)
            idxs.append(idx.clamp_min(0).to(torch.int64))
        if not d2s:
            return (query.new_zeros((0, k)),
                    torch.zeros((0, k), dtype=torch.int64, device=query.device))
        return torch.cat(d2s), torch.cat(idxs)
