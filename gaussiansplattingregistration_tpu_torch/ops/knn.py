"""Nearest-neighbor search: blocked brute-force sweeps and a 27-cell grid.

Torch counterpart of `gaussiansplattingregistration_tpu/ops/knn.py`, with the
same names, the same results and the same tie order where the reduction
defines one (`min` and `argmin` keep the first minimum, as JAX's do).

Distances for D <= 4 are summed per coordinate, (q_i - d_j)^2, never by the
Gram trick |q|^2 + |d|^2 - 2 q.d: that is a matmul whose cancellation
swamps the distance between close points (and `torch.cdist` takes that route
in its default compute mode). For D > 4 the Gram form runs as a float32
matmul; the package turns TF32 off at import, so it is not rounded to TF32.

Queries are processed in blocks chosen so that each [B, N] float32
temporary stays within `BLOCK_BYTES` (256 MB): at 100k x 100k an unblocked
tile would take 40 GB. The JAX package blocks by a fixed `block_size` for
its compiler; the torch functions keep the keyword, and take the budget's
block when it is None.

Every function runs on the device of its inputs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gaussiansplattingregistration_tpu_torch.utils import profiling

BLOCK_BYTES = 256 << 20
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
    order of exactly tied distances is torch.topk's and may differ from
    JAX's."""
    del approx
    with profiling.span("knn.knn"):
        profiling.count("knn.pairs", query.shape[0] * data.shape[0])
        return _knn(query, data, k, block_size)


def _knn(query, data, k, block_size):
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
    """Single nearest neighbor: (sq_distance [Q], index [Q] int64). One
    `min` over each [B, N] tile gives both; ties keep the first index."""
    with profiling.span("knn.nearest"):
        profiling.count("knn.pairs", query.shape[0] * data.shape[0])
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
