"""Torch port vs JAX package: gradients of the rasterizer.

The compositor's backward twin against `jax.vjp` of
`raster_pallas.composite_tiles_pallas` (its `_bwd_kernel` in interpret mode)
and against autograd of the forward twin; the whole rasterizer's gradients
against JAX's for the pairs port "cuda" <-> JAX "pallas" and port "torch"
<-> JAX "xla"; the committed f64 golden; the gather VJP; and the
backward-cap, bf16-transport and `max_live_tiles` cases.

Tolerance for gradients: 1e-3 of each tensor's (or channel's) max abs, the
JAX suite's (tests/test_raster_pallas.py): pixel sums run in another order,
and the backward kernel's suffix sum is taken another way. The golden at its
own contract (tests/test_goldens.py).
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gaussiansplattingregistration_tpu.ops import raster_pallas
from gaussiansplattingregistration_tpu.ops import rasterize as JR
from gaussiansplattingregistration_tpu_torch.ops import raster_cuda
from gaussiansplattingregistration_tpu_torch.ops import rasterize as TR
from tests.test_rasterize import HEIGHT, WIDTH, make_camera, make_scene
from tests.test_torch_rasterize import DATA, jax_config, random_tiles, scene_arrays
from port_scenes import pair_counts, two_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_torch_threads")

PARAMS = ("means", "cov", "opacity", "features")


def assert_grads_close(got, want, rel=1e-3):
    for g, w, name in zip(got, want, PARAMS):
        w = np.asarray(w)
        scale = np.abs(w).max()
        assert scale > 0, name
        np.testing.assert_allclose(np.asarray(g), w, atol=rel * scale, err_msg=name)


def port_grads(arrays, bg, cfg, loss):
    """Gradients of loss(rgb, alpha) w.r.t. means, cov, opacity, features."""
    *data, w, h, deg = arrays
    params = [torch.tensor(a, requires_grad=True) for a in data[:4]]
    rgb, alpha, _ = TR.rasterize_arrays(*params, data[4], data[5], w, h, deg,
                                        np.asarray(bg, np.float32), cfg, device="cpu")
    return [g.numpy() for g in torch.autograd.grad(loss(rgb, alpha, torch), params)]


def jax_grads(arrays, bg, cfg, loss):
    *data, w, h, deg = arrays

    def f(m, c, o, ft):
        rgb, alpha, _ = JR.rasterize_arrays(m, c, o, ft, jnp.asarray(data[4]),
                                            jnp.asarray(data[5]), w, h, deg,
                                            jnp.asarray(bg, jnp.float32), jax_config(cfg))
        return loss(rgb, alpha, jnp)

    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2, 3))(*map(jnp.asarray, data[:4]))]


def mse_alpha_loss(rgb, alpha, xp):
    """The loss of tests/test_raster_pallas.py (target zero)."""
    return xp.mean(rgb ** 2) + 0.1 * xp.mean(alpha)


def sum_sq_loss(rgb, alpha, xp):
    return xp.sum(rgb * rgb)


# ------------------------------------------------- compositor backward twin

@pytest.mark.parametrize("K,fixed", [(384, [0, 1, 127, 128, 129, 384]),
                                     (64, [0, 1, 63, 64])])
def test_composite_bwd_twin_matches_pallas_vjp(rng, K, fixed):
    counts = fixed + list(rng.integers(0, K + 1, 16 - len(fixed)))
    gT, cnt = random_tiles(rng, counts, K)
    T0, P = gT.shape[0], 256
    g_rgb = rng.normal(size=(T0, P, 3)).astype(np.float32)
    g_a = rng.normal(size=(T0, P)).astype(np.float32)
    g_d = rng.normal(size=(T0, P)).astype(np.float32)
    cfg = TR.RasterizeConfig()
    # The saturating tiles reach the alpha_max clamp, where 1/(1 - alpha) = 1000.
    assert pair_counts(torch.as_tensor(gT), torch.as_tensor(cnt), 16, cfg)["clamped"] > 0
    got = raster_cuda.composite_tiles_reference_bwd(
        torch.as_tensor(gT), torch.as_tensor(cnt), torch.as_tensor(g_rgb),
        torch.as_tensor(g_a), torch.as_tensor(g_d), 16, cfg).numpy()

    _, vjp = jax.vjp(lambda g: raster_pallas.composite_tiles_pallas(
        g, jnp.asarray(cnt), 16, jax_config(cfg)), jnp.asarray(gT))
    (want,) = vjp((jnp.asarray(g_rgb), jnp.asarray(g_a), jnp.asarray(g_d), jnp.zeros(T0)))
    want = np.asarray(want)

    x = torch.tensor(gT, requires_grad=True)
    out = raster_cuda.composite_tiles_reference(x, torch.as_tensor(cnt), 16, cfg)
    loss = ((out[0] * torch.as_tensor(g_rgb)).sum() + (out[1] * torch.as_tensor(g_a)).sum()
            + (out[2] * torch.as_tensor(g_d)).sum())
    (auto,) = torch.autograd.grad(loss, x)

    for ch in range(10):
        scale = np.abs(want[:, ch]).max()
        assert scale > 0
        np.testing.assert_allclose(got[:, ch], want[:, ch], atol=1e-3 * scale, err_msg=str(ch))
        np.testing.assert_allclose(got[:, ch], auto[:, ch].numpy(), atol=1e-3 * scale,
                                   err_msg=str(ch))
    for t, c in enumerate(counts):
        assert (got[t, :, c:] == 0).all()


# ------------------------------------------------- whole rasterizer vs JAX

@pytest.mark.parametrize("backend,K", [("cuda", 64), ("torch", 64), ("cuda", 512)])
def test_rasterizer_gradients_match_jax(rng, backend, K):
    """tests/test_raster_pallas.py's scene and loss; K=512 puts four
    128-entry chunks in the backward (the JAX kernel's recompute case)."""
    cloud = make_scene(rng, n=20, scale=(0.1, 0.3))
    arrays = scene_arrays(cloud, make_camera(width=32, height=32))
    cfg = TR.RasterizeConfig(max_tiles_per_splat=16, max_splats_per_tile=K, tile_chunk=4,
                             backend=backend)
    bg = (0.0, 0.0, 0.0)
    assert_grads_close(port_grads(arrays, bg, cfg, mse_alpha_loss),
                       jax_grads(arrays, bg, cfg, mse_alpha_loss))


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_pixel_gradients_match_golden(backend):
    """Loss sum(rgb * ct) and its gradients vs the committed f64 central
    differences, at tests/test_goldens.py's tolerances."""
    g = np.load(os.path.join(DATA, "golden_raster.npz"))
    cfg = TR.RasterizeConfig(max_tiles_per_splat=16, max_splats_per_tile=64, tile_chunk=4,
                             backend=backend)
    params = [torch.tensor(g[k], dtype=torch.float32, requires_grad=True)
              for k in ("means", "cov6", "opacity", "features")]
    rgb, _, _ = TR.rasterize_arrays(*params, g["viewmat"], g["intrinsics"], int(g["width"]),
                                    int(g["height"]), int(g["sh_degree"]), g["background"],
                                    cfg, device="cpu")
    loss = torch.sum(rgb * torch.tensor(g["ct"], dtype=torch.float32))
    np.testing.assert_allclose(float(loss.detach()), float(g["loss"]), rtol=1e-4)
    grads = torch.autograd.grad(loss, params)
    for got, key in zip(grads, ("grad_means", "grad_cov", "grad_opacity", "grad_features")):
        want = g[key]
        scale = np.abs(want).max()
        np.testing.assert_allclose(got.numpy().astype(np.float64), want, rtol=5e-3,
                                   atol=5e-3 * scale, err_msg=key)


# ------------------------------------------------------------ gather VJP

@pytest.mark.parametrize("C", [1, 2, 3, 5, 9, 16])
def test_gather_entries_vjp_matches_plain_and_jax(rng, C):
    """tests/test_rasterize.py's case: the index_add_ VJP equals the plain
    autograd VJP of the same gather and JAX's custom VJP, uncapped and
    capped at KB=3 (the cap zeroes cotangent ranks past it)."""
    n, F = 37, 10
    cfg = TR.RasterizeConfig(max_tiles_per_splat=C, max_splats_per_tile=8, backend="torch")
    means2d = rng.uniform(0, 64, size=(n, 2)).astype(np.float32)
    radius = rng.uniform(1, 20, size=n).astype(np.float32)
    depth = rng.uniform(0.5, 5.0, size=n).astype(np.float32)
    valid = rng.uniform(size=n) > 0.2
    packed = rng.normal(size=(n, F)).astype(np.float32)

    for KB in (None, 3):
        c = dataclasses.replace(cfg, max_bwd_splats_per_tile=KB)
        table = TR._build_tile_table(torch.as_tensor(means2d), torch.as_tensor(radius),
                                     torch.as_tensor(depth), torch.as_tensor(valid),
                                     4, 3, c)[0]
        ct = rng.normal(size=(table.shape[0], F, table.shape[1])).astype(np.float32)

        p = torch.tensor(packed, requires_grad=True)
        (got,) = torch.autograd.grad(
            TR.gather_entries(p, table, C, TR.bwd_rank_cap(c)), p, torch.as_tensor(ct))

        splat = torch.where(table >= 0, table // C, 0).long()
        plain = (p[splat] * (table >= 0).float()[..., None]).permute(0, 2, 1)
        ct_masked = ct * (np.arange(table.shape[1]) < TR.bwd_rank_cap(c))[None, None, :]
        (want,) = torch.autograd.grad(plain, p, torch.as_tensor(ct_masked))
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)

        jtable, jsorted, jlive, *_ = JR._build_tile_table(
            jnp.asarray(means2d), jnp.asarray(radius), jnp.asarray(depth),
            jnp.asarray(valid), 4, 3, jax_config(c))
        np.testing.assert_array_equal(table.numpy(), np.asarray(jtable))
        _, vjp = jax.vjp(lambda q: JR.gather_entries(q, jtable, jsorted, jlive, C, KB),
                         jnp.asarray(packed))
        (jgot,) = vjp(jnp.asarray(ct))
        np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=1e-6, atol=1e-6)


# -------------------------------------------- caps and the bf16 transport

@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_bwd_cap_exactness_and_truncation(rng, backend):
    """tests/test_rasterize.py's case: a cap of K gives the uncapped
    gradients bit for bit, a tiny cap drops tails on a deep scene; both
    against JAX's."""
    cloud = make_scene(rng, n=96, sh_degree=0, spread=0.2, scale=(0.2, 0.4))
    arrays = scene_arrays(cloud, make_camera())
    base = TR.RasterizeConfig(max_tiles_per_splat=8, max_splats_per_tile=64, backend=backend)

    def grads(cfg):
        *data, w, h, deg = arrays
        op = torch.tensor(data[2], requires_grad=True)
        rgb, _, _ = TR.rasterize_arrays(data[0], data[1], op, *data[3:], w, h, deg,
                                        np.zeros(3, np.float32), cfg, device="cpu")
        return torch.autograd.grad(rgb.sum(), op)[0].numpy()

    def jgrads(cfg):
        *data, w, h, deg = arrays

        def f(o):
            return jnp.sum(JR.rasterize_arrays(
                jnp.asarray(data[0]), jnp.asarray(data[1]), o, jnp.asarray(data[3]),
                jnp.asarray(data[4]), jnp.asarray(data[5]), w, h, deg, jnp.zeros(3),
                jax_config(cfg))[0])

        return np.asarray(jax.grad(f)(jnp.asarray(data[2])))

    g_none = grads(base)
    np.testing.assert_array_equal(g_none, grads(dataclasses.replace(base, max_bwd_splats_per_tile=64)))
    tiny = dataclasses.replace(base, max_bwd_splats_per_tile=4)
    g_tiny = grads(tiny)
    assert not np.allclose(g_none, g_tiny)
    for got, cfg in ((g_none, base), (g_tiny, tiny)):
        want = jgrads(cfg)
        np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max())


def test_bf16_cotangent_transport_close_to_f32(rng):
    """bwd_sort_bf16 rounds each entry's cotangent to bf16 before it lands:
    the gradients match JAX's bf16 transport and stay within the JAX test's
    bounds of the f32 path."""
    cloud = make_scene(rng, n=400, scale=(0.05, 0.15))   # the JAX test's scene
    arrays = scene_arrays(cloud, make_camera())
    base = TR.RasterizeConfig(max_tiles_per_splat=8, max_splats_per_tile=64, tile_chunk=4)
    weights = np.cos(np.arange(HEIGHT * WIDTH * 3)).reshape(HEIGHT, WIDTH, 3).astype(np.float32)

    def loss(rgb, alpha, xp):
        return xp.sum(rgb * xp.asarray(weights))

    bf16 = dataclasses.replace(base, bwd_sort_bf16=True)
    g32 = port_grads(arrays, (0.0, 0.0, 0.0), base, loss)
    g16 = port_grads(arrays, (0.0, 0.0, 0.0), bf16, loss)
    assert_grads_close(g16, jax_grads(arrays, (0.0, 0.0, 0.0), bf16, loss))
    assert any(not np.array_equal(a, b) for a, b in zip(g32, g16))
    for name, a, b in zip(PARAMS, g32, g16):
        a, b = a.astype(np.float64), b.astype(np.float64)
        scale = np.abs(a).max()
        tol = 5e-2 if name == "features" else 1.2e-2
        np.testing.assert_allclose(b, a, atol=tol * scale, err_msg=name)
        assert np.linalg.norm(b - a) / np.linalg.norm(a) < 2e-2, name


def sliced_scene(rng):
    """A 10x6-tile view whose live tiles have the highest image ids."""
    cloud = make_scene(rng, n=120, spread=0.5, scale=(0.02, 0.06))
    cloud = dataclasses.replace(cloud, xyz=cloud.xyz + jnp.asarray([0.8, 0.6, 0.0], jnp.float32))
    return scene_arrays(cloud, make_camera(width=160, height=96))


def test_max_live_tiles_sliced_gradients(rng):
    """tests/test_rasterize.py's regression case: a cap that slices rows
    off but keeps every live tile gives the unsliced gradients, and JAX's."""
    arrays = sliced_scene(rng)
    base = TR.RasterizeConfig(max_tiles_per_splat=4, max_splats_per_tile=64, tile_chunk=4)
    capped = dataclasses.replace(base, max_live_tiles=16)
    *data, w, h, deg = arrays
    stats = TR.rasterize_arrays_with_stats(*data, w, h, deg, np.zeros(3, np.float32), capped,
                                           device="cpu")[3]
    assert int(stats["live_tile_overflow"]) == 0 and TR._row_cap(capped, 60) < 60
    bg = (0.0, 0.0, 0.0)
    got = port_grads(arrays, bg, capped, sum_sq_loss)
    np.testing.assert_allclose(got[0], port_grads(arrays, bg, base, sum_sq_loss)[0], atol=1e-5)
    assert_grads_close(got, jax_grads(arrays, bg, capped, sum_sq_loss))


def test_max_live_tiles_overflow_gradients(rng):
    """What the port does when live tiles fall past the cap: they render as
    background (zero here) and carry no gradient, and no other gradient
    changes. So every splat's gradient equals that of the uncapped render
    under a loss that counts only the kept tiles' pixels."""
    arrays = sliced_scene(rng)
    base = TR.RasterizeConfig(max_tiles_per_splat=4, max_splats_per_tile=64, tile_chunk=4)
    tight = dataclasses.replace(base, max_live_tiles=8)
    *data, w, h, deg = arrays
    bg = (0.0, 0.0, 0.0)
    assert int(TR.rasterize_arrays_with_stats(*data, w, h, deg, np.zeros(3, np.float32), tight,
                                              device="cpu")[3]["live_tile_overflow"]) > 0
    proj = TR.project_gaussians(*(torch.tensor(a) for a in (data[0], data[1], data[4], data[5])),
                                w, h, tight)
    order = TR._build_tile_table(proj["means2d"], proj["radius"], proj["depth"],
                                 proj["valid"], 10, 6, tight)[4]
    kept = np.zeros(60, np.float32)
    kept[order[:TR._row_cap(tight, 60)].numpy()] = 1.0
    mask = np.repeat(np.repeat(kept.reshape(6, 10), 16, axis=0), 16, axis=1)[..., None]

    def kept_loss(rgb, alpha, xp):
        return xp.sum(rgb * rgb * xp.asarray(mask))

    g_tight = port_grads(arrays, bg, tight, sum_sq_loss)
    g_kept = port_grads(arrays, bg, base, kept_loss)
    assert_grads_close(g_tight, g_kept, rel=1e-5)
    g_full = port_grads(arrays, bg, base, sum_sq_loss)
    assert not np.allclose(g_tight[0], g_full[0])
