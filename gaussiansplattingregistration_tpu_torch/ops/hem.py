"""Hierarchical EM (HEM) Gaussian-mixture downsampler.

Torch counterpart of `gaussiansplattingregistration_tpu/ops/hem.py`, itself a
re-implementation of the reference's C++ extension (`mixture.cpp:25-333`):

* per-parent conservative query radius = distance_delta * sqrt(lambda_max),
  realized as a fixed-K nearest-neighbor candidate set (a global exact top-k,
  or the k nearest within the parent's 27-cell grid window);
* child eligibility: color distance <= color_delta^2/2, KL divergence <=
  distance_delta^2/2, other parents excluded;
* likelihood = the opacity-weighted kernel exp(-d^2/decay^2) * opacity *
  exp(-dcolor^2/decay^2) * sqrt(det cov), clamped to [FLT_MIN, 1e8] and
  weighted by the parent's weight;
* responsibilities, accumulation of mean, color, covariance (relative to the
  parent mean), opacity, SH features and wrapped-normal statistics;
* orphans pass through; new parent flags ~ Bernoulli(1/hem_reduction); NaN
  and non-PSD components die. Level 0 is dropped from the result.

Opacities are activated (sigmoid) values, as in the JAX package.

What differs from the JAX package, by design:
* draws come from a `torch.Generator` seeded with `seed` on the state's
  device. A CPU stream, a CUDA stream and `jax.random` differ for one seed,
  so parity is tested with injected parent flags;
* the candidate search and everything after it run on the parent rows
  only (the JAX function computes every row and masks the rest; the
  results are the same), and `create_mixture` keeps only alive rows
  between levels. JAX's static shapes, its padded grid tables and its
  batched host syncs exist for its compiler and its link to the device;
  the port keeps their result: compacted host `MixtureLevel`s;
* the per-child sum of responsibilities is a sorted pairwise-tree
  reduction, not an atomic scatter-add, so a level is the same bits every
  time it runs on the card;
* `knn`'s top-k is exact where the JAX package uses `approx_max_k` on TPU.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from gaussiansplattingregistration_tpu_torch.models.parameters import GaussianMixtureParams
from gaussiansplattingregistration_tpu_torch.ops import knn as knn_ops
from gaussiansplattingregistration_tpu_torch.ops import math3d
from gaussiansplattingregistration_tpu_torch.utils import profiling

_FLT_MIN = 1.175494e-38
_MAX_L = 1e8


@dataclasses.dataclass(frozen=True)
class MixtureState:
    """One HEM level as slot tensors (dead slots masked)."""

    mean: torch.Tensor       # [N, 3]
    color: torch.Tensor      # [N, 3] SH-DC colors
    cov: torch.Tensor        # [N, 6] packed covariance
    opacity: torch.Tensor    # [N] activated opacity
    weight: torch.Tensor     # [N]
    features: torch.Tensor   # [N, F] flattened SH rest
    nvar: torch.Tensor       # [N, 3] normal * variance encoding
    is_parent: torch.Tensor  # [N] bool
    alive: torch.Tensor      # [N] bool

    def select(self, rows) -> "MixtureState":
        return MixtureState(**{f.name: getattr(self, f.name)[rows]
                               for f in dataclasses.fields(self)})


@dataclasses.dataclass
class MixtureLevel:
    """Host-side compacted level (the reference's `GaussianMixtureModel`)."""

    xyz: np.ndarray
    colors: np.ndarray
    opacities: np.ndarray
    covariance: np.ndarray
    features: np.ndarray


def _det6(cov6: torch.Tensor) -> torch.Tensor:
    a, b, c, d, e, f = cov6.unbind(-1)
    return a * (d * f - e * e) - b * (b * f - c * e) + c * (b * e - c * d)


def _inv6(cov6: torch.Tensor) -> torch.Tensor:
    """Inverse of packed symmetric 3x3, packed again. Adjugate / det."""
    a, b, c, d, e, f = cov6.unbind(-1)
    det = _det6(cov6)
    det = torch.where(torch.abs(det) < 1e-30,
                      torch.sign(det) * 1e-30 + (det == 0) * 1e-30, det)
    return torch.stack([(d * f - e * e) / det, (c * e - b * f) / det, (b * e - c * d) / det,
                        (a * f - c * c) / det, (b * c - a * e) / det, (a * d - b * b) / det],
                       dim=-1)


def _mahalanobis6(diff: torch.Tensor, inv6: torch.Tensor) -> torch.Tensor:
    """diff [.., 3], inv6 [.., 6] -> diff^T Sigma^-1 diff."""
    x, y, z = diff.unbind(-1)
    a, b, c, d, e, f = inv6.unbind(-1)
    return (a * x * x + d * y * y + f * z * z
            + 2.0 * (b * x * y + c * x * z + e * y * z))


def _trace_product6(inv_p: torch.Tensor, cov_c: torch.Tensor) -> torch.Tensor:
    """trace(Sigma_p^-1 Sigma_c) for packed matrices."""
    a, b, c, d, e, f = inv_p.unbind(-1)
    A, B, C, D, E, F = cov_c.unbind(-1)
    return (a * A + b * B + c * C) + (b * B + d * D + e * E) + (c * C + e * E + f * F)


def _max_eigenvalue6(cov6: torch.Tensor) -> torch.Tensor:
    """Largest eigenvalue of packed symmetric 3x3: the trigonometric
    solution of the characteristic cubic, as `native/hem.cpp` computes it."""
    a, b, c, d, e, f = cov6.unbind(-1)
    q = (a + d + f) / 3.0
    p1 = b * b + c * c + e * e
    aq, dq, fq = a - q, d - q, f - q
    p2 = aq * aq + dq * dq + fq * fq + 2.0 * p1
    p = torch.sqrt(torch.clamp_min(p2 / 6.0, 0.0))
    safe_p = torch.clamp_min(p, 1e-30)
    det_b = (aq * (dq * fq - e * e) - b * (b * fq - c * e) + c * (b * e - c * dq)) \
        / (safe_p * safe_p * safe_p)
    phi = torch.arccos(torch.clamp(det_b / 2.0, -1.0, 1.0)) / 3.0
    return torch.where(p2 <= 1e-30, q, q + 2.0 * p * torch.cos(phi))


def _parent_draw(generator: torch.Generator, n: int, hem_reduction: float, device):
    return torch.rand(n, generator=generator, device=device) < (1.0 / hem_reduction)


def init_mixture(
    generator: torch.Generator,
    xyz: torch.Tensor,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    cov6: torch.Tensor,
    features: torch.Tensor,
    hem_reduction: float,
) -> MixtureState:
    """Level-0 init: weight 1, initial normal = the covariance's
    smallest-eigenvalue eigenvector scaled by variance 0.001, parent flags ~
    Bernoulli(1/hem_reduction) from `generator` (on the tensors' device)."""
    n = xyz.shape[0]
    _, vecs = math3d.symmetric_eigh(math3d.unpack_symmetric(cov6))
    return MixtureState(
        mean=xyz,
        color=colors,
        cov=cov6,
        opacity=opacities.reshape(n),
        weight=torch.ones((n,), dtype=xyz.dtype, device=xyz.device),
        features=features.reshape(n, -1),
        nvar=vecs[..., :, 0] * 0.001,
        is_parent=_parent_draw(generator, n, hem_reduction, xyz.device),
        alive=torch.ones((n,), dtype=torch.bool, device=xyz.device),
    )


def _sum_per_child(n: int, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """sum of val per index in [0, n) with no atomics: the entries sorted by
    index (stable: parent-major within a child), then each child's run
    summed by a pairwise tree over its ranks, so every run gives the same
    bits. Memory stays O(entries + n) whatever a child's in-degree: the
    grid search's empty slots all name child 0 (with val 0), so a padded
    [n, max in-degree] buffer would grow with the sparse windows."""
    idx, val = idx.reshape(-1), val.reshape(-1)
    e = idx.numel()
    if e == 0:
        return val.new_zeros((n,))
    sidx, perm = torch.sort(idx, stable=True)
    acc = val[perm]
    counts = torch.bincount(sidx, minlength=n)
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(e, device=idx.device) - start[sidx]
    left = counts[sidx] - rank  # entries from this one to its run's end
    step = 1
    while step < e:  # no run is longer than e; a static bound needs no host read
        take = (torch.remainder(rank, 2 * step) == 0) & (left > step)
        acc = torch.where(take, acc + torch.cat([acc[step:], acc.new_zeros((step,))]), acc)
        step *= 2
    return torch.where(counts > 0, acc[start.clamp_max(e - 1)], 0.0)


def _outer6(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v.unbind(-1)
    return torch.stack([x * x, x * y, x * z, y * y, y * z, z * z], dim=-1)


def hem_cluster_level(
    generator: torch.Generator,
    state: MixtureState,
    hem_reduction: float,
    distance_delta: float,
    color_delta: float,
    decay_rate: float,
    max_children: int = 32,
    with_stats: bool = False,
    use_grid: bool = False,
    grid_table=None,       # [n_cells, W*4] (knn.build_grid_table)
    grid_origin=None,
    grid_inv_cell=None,
    grid_dims=None,        # (nx, ny, nz)
    max_parent_slots: Optional[int] = None,
):
    """One HEM clustering round (`createClusterLevel`, `mixture.cpp:66-285`).

    Slot semantics: parent slots receive the merged component, orphan slots
    pass through, all other slots die; the output has the input's slots.
    Candidate children per parent come from a global k nearest neighbor
    sweep over alive points, or (use_grid) the k nearest within the
    parent's 27-cell window of a table whose cell is >= every parent's
    query radius.

    `max_parent_slots` is the JAX package's query budget: when there are
    more parents, those past the first `max_parent_slots` (in index order)
    get no candidates and pass through as orphans (`parent_overflow`).

    With `with_stats`, returns (state, stats): `saturated_parents` =
    parents whose K-th candidate is still inside the query radius (the
    radius search would have found more children than K), plus counts of
    parents, overflowed parents, merged, orphans and alive slots."""
    n = state.mean.shape[0]
    dev, dt = state.mean.device, state.mean.dtype
    k = min(max_children, n)
    with profiling.span("hem.candidates"):
        parent_mask = state.is_parent & state.alive
        child_alive = state.alive
        P = torch.nonzero(parent_mask)[:, 0]
        parent_overflow = 0
        if max_parent_slots is not None and max_parent_slots < n and P.numel() > max_parent_slots:
            parent_overflow = P.numel() - max_parent_slots
            P = P[:max_parent_slots]

        p_mean, p_cov, p_color = state.mean[P], state.cov[P], state.color[P]
        if use_grid:
            d2, idx = knn_ops.grid_topk(p_mean, grid_table, grid_origin, grid_inv_cell,
                                        grid_dims, k)
        else:
            far = torch.where(child_alive[:, None], state.mean, 1e12)
            d2, idx = knn_ops.knn(p_mean, far, k=k)
    with profiling.span("hem.merge"):
        query_radius = distance_delta * torch.sqrt(torch.clamp_min(_max_eigenvalue6(p_cov), 0.0))
        in_radius = d2 <= (query_radius[:, None] ** 2)

        c_mean, c_color, c_cov = state.mean[idx], state.color[idx], state.cov[idx]
        c_alive = child_alive[idx]

        # --- eligibility (mixture.cpp:116-136) ---------------------------------
        color_diff = torch.linalg.norm(c_color - p_color[:, None, :], dim=-1)
        ok_color = color_diff <= (color_delta * color_delta * 0.5)
        inv_p = _inv6(p_cov)[:, None, :]
        smd = _mahalanobis6(c_mean - p_mean[:, None, :], inv_p)
        tr = _trace_product6(inv_p, c_cov)
        det_c = torch.clamp_min(_det6(c_cov), 1e-30)
        det_p = torch.clamp_min(_det6(p_cov), 1e-30)[:, None]
        kld = 0.5 * (smd + tr - 3.0 - torch.log(det_c / det_p))
        ok_kld = kld <= (distance_delta * distance_delta * 0.5)
        ok_parent = ~state.is_parent[idx] | (idx == P[:, None])
        eligible = in_radius & ok_color & ok_kld & ok_parent & c_alive

        # --- likelihoods (hemLikelihoodOpacity, mixture.cpp:54-64) -------------
        dist = torch.sqrt(torch.clamp_min(d2, 0.0))
        dist_w = torch.exp(-(dist * dist) / (decay_rate * decay_rate))
        color_w = torch.exp(-(color_diff * color_diff) / (decay_rate * decay_rate))
        c_opacity = state.opacity[idx]
        L = dist_w * c_opacity * color_w * torch.sqrt(torch.clamp_min(det_c, 0.0))
        wL = state.weight[P][:, None] * torch.clamp(L, _FLT_MIN, _MAX_L)
        wL = torch.where(eligible, wL, 0.0)

        # --- responsibilities: sum over parents per child ----------------------
        sum_lw = _sum_per_child(n, idx, wL)
        denom = sum_lw[idx]
        r = torch.where(denom > 0, wL / torch.clamp_min(denom, _FLT_MIN), 0.0)
        w = r * state.weight[idx]

        # --- accumulate (mixture.cpp:186-244) ----------------------------------
        w_s = torch.sum(w, dim=1)
        inv_w = 1.0 / torch.clamp_min(w_s, 1e-30)
        mean_s = torch.einsum("nk,nkc->nc", w, c_mean) * inv_w[:, None]
        col_s = torch.einsum("nk,nkc->nc", w, c_color) * inv_w[:, None]
        # covariance accumulated relative to the parent mean (mixture.cpp:212)
        sumcov = torch.einsum("nk,nkc->nc", w, c_cov + _outer6(c_mean - p_mean[:, None, :]))
        cov_s = sumcov * inv_w[:, None] - _outer6(mean_s - p_mean)
        opacity_s = torch.einsum("nk,nk->n", w, c_opacity) * inv_w
        feat_s = torch.einsum("nk,nkf->nf", w, state.features[idx]) * inv_w[:, None]

        # wrapped-normal statistics (mixture.cpp:199-244)
        c_nvar = state.nvar[idx]
        c_nlen = torch.clamp_min(torch.linalg.norm(c_nvar, dim=-1), 1e-30)
        c_normal = c_nvar / c_nlen[..., None]
        flip = torch.sign(torch.sum(c_normal * state.nvar[P][:, None, :], dim=-1))
        flip = torch.where(flip == 0, 1.0, flip)
        resultant = torch.einsum("nk,nkc->nc", w, c_normal * flip[..., None])
        nvar_sum = torch.einsum("nk,nk->n", w, c_nlen)
        R = torch.clamp_min(torch.linalg.norm(resultant, dim=-1), 1e-30)
        variance1 = nvar_sum * inv_w
        variance2 = -2.0 * torch.log(torch.clamp(R * inv_w, 1e-6, 1.0))
        nvar_s = resultant / R[:, None] * (variance1 + variance2)[:, None]

        # --- compose output slots ----------------------------------------------
        merged_p = w_s > 0
        merged_ok = torch.zeros(n, dtype=torch.bool, device=dev)
        merged_ok[P] = merged_p
        orphan = child_alive & (sum_lw == 0.0)

        def pick(old, new):
            out = old.clone()
            m = merged_p.reshape((-1,) + (1,) * (new.ndim - 1))
            out[P] = torch.where(m, new, old[P])
            return out

        out_cov = pick(state.cov, cov_s)
        out_mean = pick(state.mean, mean_s)
        det_out = _det6(out_cov)
        bad = (~torch.isfinite(out_mean).all(dim=-1)) | ~torch.isfinite(det_out) | (det_out <= 0.0)
        alive = (merged_ok | orphan) & ~bad
        out = MixtureState(
            mean=out_mean,
            color=pick(state.color, col_s),
            cov=out_cov,
            opacity=pick(state.opacity, opacity_s),
            weight=pick(state.weight, w_s),
            features=pick(state.features, feat_s),
            nvar=pick(state.nvar, nvar_s),
            is_parent=_parent_draw(generator, n, hem_reduction, dev) & alive,
            alive=alive,
        )
    if not with_stats:
        return out
    stats = {
        "saturated_parents": int(torch.sum(in_radius[:, -1] & c_alive[:, -1])) if k else 0,
        "parents": int(torch.sum(parent_mask)),
        "parent_overflow": int(parent_overflow),
        "merged": int(torch.sum(merged_ok)),
        "orphans": int(torch.sum(orphan)),
        "alive": int(torch.sum(alive)),
    }
    return out, stats


def _level(state: MixtureState) -> MixtureLevel:
    host = lambda a: a.detach().cpu().numpy()  # noqa: E731
    return MixtureLevel(xyz=host(state.mean), colors=host(state.color),
                        opacities=host(state.opacity), covariance=host(state.cov),
                        features=host(state.features))


def create_mixture(
    cloud,
    params: GaussianMixtureParams,
    seed: int = 0,
    max_children: int = 32,
    backend: str = "torch",
    with_stats: bool = False,
    neighbor_search: str = "auto",
):
    """Run `cluster_level` HEM rounds over a GaussianCloud on its device;
    returns levels 1..cluster_level as host `MixtureLevel`s (level 0, the
    input, is dropped, as the reference's `CreateMixture` drops it).

    backend: "torch" (fixed-K candidates) or "native" (`native/hem.cpp` on
    the host, exact radius search, built by `utils/native.py`; it raises
    when g++ or the library is missing and never falls back to "torch").

    neighbor_search: "global", "grid" or "auto" (grid for clouds of >= 10k
    points while a level's plan is feasible; once one fails, later levels
    keep the global search, as in the JAX package).

    With `with_stats` ("torch" only), returns (levels, per-level stats
    dicts: `hem_cluster_level`'s, plus `grid_search`, 1 where that level's
    candidates came from the grid)."""
    if backend not in ("torch", "native"):
        raise ValueError(f"unknown HEM backend {backend!r}")
    with profiling.span("hem.create_mixture"):
        if backend == "native":
            levels = _create_mixture_native(cloud, params, seed)
            return (levels, []) if with_stats else levels
        return _create_mixture_torch(cloud, params, seed, max_children, with_stats,
                                     neighbor_search)


def _create_mixture_torch(cloud, params: GaussianMixtureParams, seed: int, max_children: int,
                          with_stats: bool, neighbor_search: str):
    if neighbor_search not in ("auto", "grid", "global"):
        raise ValueError(f"unknown neighbor_search {neighbor_search!r}")
    n_slots = cloud.num_points
    generator = torch.Generator(device=cloud.device)
    generator.manual_seed(seed)
    state = init_mixture(
        generator, cloud.xyz, cloud.get_colors, cloud.get_opacity[:, 0],
        cloud.get_covariance(), cloud.features_rest.reshape(n_slots, -1),
        params.hem_reduction,
    )
    # The JAX package's parent budget: ~N/reduction parents + a Binomial-tail
    # margin. Past it, parents are orphaned; it practically never binds.
    budget = int(n_slots / max(float(params.hem_reduction), 1.01) * 1.15)
    budget = min(n_slots, -(-(budget + 256) // 1024) * 1024)
    want_grid = neighbor_search == "grid" or (neighbor_search == "auto" and n_slots >= 10_000)
    levels, all_stats = [], []
    for _ in range(params.cluster_level):
        with profiling.span("hem.level"):
            grid_kw = {}
            if want_grid:
                with profiling.span("hem.plan"):
                    grid_kw = _level_grid(state, float(params.distance_delta))
                # Under "auto", once a plan fails the later levels keep the
                # global search: coarser levels only grow the query radius
                # while the alive count shrinks slower than the cell count.
                want_grid = bool(grid_kw) or neighbor_search == "grid"
            out = hem_cluster_level(
                generator, state, float(params.hem_reduction), float(params.distance_delta),
                float(params.color_delta), float(params.decay_rate),
                max_children=max_children, with_stats=with_stats,
                max_parent_slots=budget if budget < n_slots else None, **grid_kw,
            )
            if with_stats:
                out, stats = out
                all_stats.append({**stats, "grid_search": int(bool(grid_kw))})
            with profiling.span("hem.compact"):
                state = out.select(torch.nonzero(out.alive)[:, 0])
            with profiling.span("hem.to_host"):
                levels.append(_level(state))
    return (levels, all_stats) if with_stats else levels


def _level_grid(state: MixtureState, distance_delta: float) -> dict:
    """`hem_cluster_level`'s grid arguments for one level (the plan and its
    table), or {} where no plan is feasible."""
    plan = _plan_level_grid(state, distance_delta)
    if plan is None:
        return {}
    origin, inv_cell, dims, max_occ = plan
    return dict(use_grid=True, grid_origin=origin, grid_inv_cell=inv_cell, grid_dims=dims,
                grid_table=knn_ops.build_grid_table(state.mean, state.alive, origin, inv_cell,
                                                    *dims, max_occ))


def _plan_level_grid(state: MixtureState, distance_delta: float,
                     max_w: int = 4096, max_cells: int = 1_000_000):
    """Host-side grid plan for one HEM level: cell >= the largest alive
    parent's query radius, so every parent's radius ball fits its 27-cell
    window. None -> the global search. The scalars of the feasibility
    precheck come to the host in one read; the alive means only when a
    cell size can pass it."""
    alive = state.alive
    parents = state.is_parent & alive
    radius = distance_delta * torch.sqrt(torch.clamp_min(_max_eigenvalue6(state.cov), 0.0))
    big = 3.4e38
    lo = torch.amin(torch.where(alive[:, None], state.mean, big), dim=0)
    hi = torch.amax(torch.where(alive[:, None], state.mean, -big), dim=0)
    pk = torch.cat([torch.amax(torch.where(parents, radius, 0.0))[None], hi - lo,
                    torch.sum(alive)[None].to(lo.dtype), torch.sum(parents)[None].to(lo.dtype)])
    pk = pk.cpu().numpy()
    rmax = float(pk[0])
    m = int(pk[4])
    if int(pk[5]) == 0 or m == 0 or not np.isfinite(rmax) or rmax <= 0:
        return None
    span = np.asarray(pk[1:4], np.float64)
    cell = rmax
    feasible = False
    for _ in range(40):
        dims = np.minimum(np.floor(span / cell).astype(np.int64) + 1, 1 << 20)
        n_cells = int(dims.prod())
        if 27 * m / max(n_cells, 1) > max_w:
            break  # coarsening only increases average occupancy
        if n_cells <= max_cells:
            feasible = True
            break
        cell *= 2.0
    if not feasible:
        return None
    return knn_ops.grid_nn_plan(state.mean[alive], rmax, max_w=max_w)


def _initial_nvar(cov6: np.ndarray) -> np.ndarray:
    """Smallest-eigenvalue eigenvector of each covariance scaled by variance
    0.001 (`mixture.cpp:318-326`), on the host."""
    full = math3d.unpack_symmetric(torch.as_tensor(np.asarray(cov6, np.float32))).numpy()
    _, vecs = np.linalg.eigh(full)
    return (vecs[..., :, 0] * 0.001).astype(np.float32)


def _create_mixture_native(cloud, params: GaussianMixtureParams, seed: int) -> List[MixtureLevel]:
    """Host C++/OpenMP HEM (native/hem.cpp) through `utils/native.py`;
    numpy's generator draws the parent flags, as in the JAX package, so
    runs are deterministic and match its native path."""
    from gaussiansplattingregistration_tpu_torch.utils import native

    rng = np.random.default_rng(seed)
    p = 1.0 / params.hem_reduction
    host = lambda a: a.detach().cpu().numpy().astype(np.float32)  # noqa: E731
    mean = host(cloud.xyz)
    color = host(cloud.get_colors)
    cov6 = host(cloud.get_covariance())
    opacity = host(cloud.get_opacity[:, 0])
    weight = np.ones(mean.shape[0], np.float32)
    features = host(cloud.features_rest.reshape(cloud.num_points, -1))
    nvar = _initial_nvar(cov6)
    levels: List[MixtureLevel] = []
    for _ in range(params.cluster_level):
        is_parent = (rng.random(mean.shape[0]) < p).astype(np.uint8)
        mean, color, cov6, opacity, weight, features, nvar = native.hem_cluster_level_native(
            mean, color, cov6, opacity, weight, features, nvar, is_parent,
            params.distance_delta, params.color_delta, params.decay_rate,
        )
        levels.append(MixtureLevel(xyz=mean.copy(), colors=color.copy(),
                                   opacities=opacity.copy(), covariance=cov6.copy(),
                                   features=features.copy()))
    return levels


def mixture_levels_to_clouds(levels: List[MixtureLevel], sh_degree: int, device=None):
    """Mixture levels back to GaussianClouds on `device` (default `cuda`)."""
    from gaussiansplattingregistration_tpu_torch.models.gaussian_cloud import GaussianCloud

    return [GaussianCloud.from_mixture(level, sh_degree, device=device) for level in levels]
