"""The port's spans and counters (`utils/profiling.py`) on the CPU.

Tracing off, nothing is recorded and no profiler range opens. Under a
`torch.profiler` session or `recording()`, a render records `raster.frame`
and its stages with one request id, the backward's spans take the
forward's id, HEM records one `hem.level` a level, `icp.iterations` counts
the ICP updates, and no `knn.*` span opens inside another. Outputs are
bitwise the same with tracing on and off. The device intervals' bookkeeping
(resolved, unresolved, dropped) runs against stand-in events.
"""

import numpy as np
import pytest
import torch

from gaussiansplattingregistration_tpu_torch.models.gaussian_cloud import GaussianCloud
from gaussiansplattingregistration_tpu_torch.models.parameters import (
    GaussianMixtureParams,
    MultiScaleRegistrationParams,
)
from gaussiansplattingregistration_tpu_torch.models.point_cloud import PointCloud
from gaussiansplattingregistration_tpu_torch.ops import hem, icp
from gaussiansplattingregistration_tpu_torch.ops import rasterize as TR
from gaussiansplattingregistration_tpu_torch.pipelines import multiscale
from gaussiansplattingregistration_tpu_torch.utils import profiling
from port_scenes import two_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_torch_threads")

RASTER_STAGES = {"raster.project", "raster.sh", "raster.bin", "raster.gather",
                 "raster.composite", "raster.unpack"}
W, H, DEG = 48, 32, 1


@pytest.fixture(autouse=True)
def fresh_tracer():
    profiling.reset()
    yield
    profiling.reset()


def scene(seed=0, n=300):
    """Splats in front of an identity camera: (means, cov3d, opacity,
    features, viewmat, intrinsics)."""
    g = torch.Generator().manual_seed(seed)
    means = torch.randn(n, 3, generator=g) * 0.6 + torch.tensor([0.0, 0.0, 4.0])
    s2 = (torch.rand(n, 3, generator=g) * 0.08 + 0.04) ** 2
    zero = torch.zeros(n)
    cov = torch.stack([s2[:, 0], zero, zero, s2[:, 1], zero, s2[:, 2]], dim=-1)
    opacity = torch.rand(n, generator=g) * 0.8 + 0.1
    features = torch.randn(n, (DEG + 1) ** 2, 3, generator=g) * 0.3
    intr = torch.tensor([[40.0, 0.0, W / 2], [0.0, 40.0, H / 2], [0.0, 0.0, 1.0]])
    return means, cov, opacity, features, torch.eye(4), intr


def render(arrays):
    return TR.rasterize_arrays(*arrays, W, H, DEG, torch.zeros(3), device="cpu")


def frame_and_grads(arrays):
    params = [a.clone().requires_grad_(True) for a in arrays[:4]]
    rgb, alpha, depth = render(params + list(arrays[4:]))
    grads = torch.autograd.grad(rgb.square().mean() + alpha.mean(), params)
    return [rgb.detach(), alpha.detach(), depth.detach()], list(grads)


def capture(seed=0, n=1200, shift=(0.0, 0.0, 0.0)):
    """A flat SH-1 capture of n splats, moved by `shift`."""
    rng = np.random.default_rng(seed)
    xyz = np.concatenate([rng.uniform(0, 1, (n, 2)), rng.normal(0, 0.01, (n, 1))], axis=1)
    xyz[:, 2] += 0.2 * np.sin(3.0 * xyz[:, 0])
    xyz = (xyz + np.asarray(shift)).astype(np.float32)
    return GaussianCloud.create(
        xyz, rng.normal(0, 0.05, (n, 1, 3)).astype(np.float32),
        rng.normal(0, 0.05, (n, 3, 3)).astype(np.float32),
        np.full((n, 1), 2.0, np.float32), np.full((n, 3), np.log(0.02), np.float32),
        np.tile(np.array([1.0, 0.0, 0.0, 0.0], np.float32), (n, 1)), sh_degree=1,
        device="cpu")


def pyramid(cloud, levels):
    return [PointCloud(points=cloud.xyz, colors=cloud.get_colors)] + [
        PointCloud(points=torch.as_tensor(lv.xyz), colors=torch.as_tensor(lv.colors))
        for lv in levels]


HEM_PARAMS = GaussianMixtureParams(cluster_level=3)
MS_PARAMS = MultiScaleRegistrationParams(voxel_values=[0.3, 0.15, 0.08], iter_values=[10, 8, 6])


def register(target_levels):
    """HEM on a moved capture, then multiscale ICP against `target_levels`."""
    levels = hem.create_mixture(capture(shift=(0.02, -0.01, 0.01)), HEM_PARAMS, seed=5)
    res = multiscale.multiscale_mixture_registration(
        pyramid(capture(shift=(0.02, -0.01, 0.01)), levels), target_levels, MS_PARAMS)
    return levels, res


@pytest.fixture(scope="module")
def target_levels():
    cloud = capture()
    return pyramid(cloud, hem.create_mixture(cloud, HEM_PARAMS, seed=4))


def by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r.name, []).append(r)
    return out


def test_tracing_off_records_nothing(monkeypatch, target_levels):
    opened = []
    monkeypatch.setattr(profiling, "_RANGE", lambda name: opened.append(name))
    assert profiling.span("x") is profiling.span("y")       # one shared no-op
    render(scene())
    frame_and_grads(scene())
    register(target_levels)
    snap = profiling.snapshot()
    assert snap["spans"] == {} and snap["counters"] == {} and snap["unresolved"] == {}
    assert profiling.records() == [] and opened == []


def test_a_profiled_render_records_the_frame_and_its_stages():
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        render(scene())
    recs = by_name(profiling.records())
    (frame,) = recs["raster.frame"]
    assert frame.parent is None
    assert RASTER_STAGES <= set(recs)
    for name in RASTER_STAGES:
        for r in recs[name]:
            assert r.parent == "raster.frame" and r.request == frame.request, r
            assert frame.start_ns <= r.start_ns <= r.end_ns <= frame.end_ns
    snap = profiling.snapshot()["spans"]
    assert snap["raster.frame"]["count"] == 1
    assert snap["raster.frame"]["self_host_s"] < snap["raster.frame"]["host_s"]
    assert snap["raster.unpack"]["count"] == 2       # the slab's and the frame's
    # The same names are host operations of the profiler's trace, nested in time.
    events = {}
    for ev in prof.events():
        if ev.name.startswith("raster."):
            assert ev.device_type == torch.autograd.DeviceType.CPU
            events.setdefault(ev.name, []).append(ev.time_range)
    assert set(events) == RASTER_STAGES | {"raster.frame"}
    (outer,) = events["raster.frame"]
    for name in RASTER_STAGES:
        for tr in events[name]:
            assert outer.start <= tr.start <= tr.end <= outer.end, name


def test_the_backward_spans_take_the_forward_request():
    with profiling.recording():
        frame_and_grads(scene())
        frame_and_grads(scene(seed=1))
    recs = by_name(profiling.records())
    frames = recs["raster.frame"]
    assert len(frames) == 2 and frames[0].request != frames[1].request
    for name in ("raster.gather_vjp", "raster.composite_vjp"):
        assert [r.request for r in recs[name]] == [f.request for f in frames], name
        assert all(r.parent is None for r in recs[name])


def test_outputs_are_bitwise_equal_with_tracing_on_and_off(target_levels):
    off_out, off_grads = frame_and_grads(scene())
    off_levels, off_res = register(target_levels)
    with profiling.recording():
        on_out, on_grads = frame_and_grads(scene())
        on_levels, on_res = register(target_levels)
    assert profiling.snapshot()["spans"]["raster.frame"]["count"] == 1
    for a, b in zip(off_out + off_grads, on_out + on_grads):
        assert torch.equal(a, b)
    for a, b in zip(off_levels, on_levels):
        assert all(np.array_equal(getattr(a, f), getattr(b, f))
                   for f in ("xyz", "colors", "opacities", "covariance", "features"))
    assert np.array_equal(off_res.transformation, on_res.transformation)
    assert off_res.num_iterations == on_res.num_iterations


def test_registration_records_levels_iterations_and_knn(target_levels):
    with profiling.recording():
        levels, _ = register(target_levels)
    snap = profiling.snapshot()
    spans, counters = snap["spans"], snap["counters"]
    assert spans["hem.create_mixture"]["count"] == 1
    assert spans["hem.level"]["count"] == HEM_PARAMS.cluster_level == len(levels)
    for name in ("hem.candidates", "hem.merge", "hem.compact", "hem.to_host"):
        assert spans[name]["count"] == HEM_PARAMS.cluster_level, name
    assert spans["multiscale.register"]["count"] == 1
    assert spans["multiscale.scale"]["count"] == len(MS_PARAMS.voxel_values)
    assert spans["icp.run"]["count"] == len(MS_PARAMS.voxel_values)
    # Normals of both clouds on each level (the levels carry none).
    assert spans["normals.estimate"]["count"] == 2 * len(MS_PARAMS.voxel_values)
    # The same ICP calls made directly, tracing off.
    src = pyramid(capture(shift=(0.02, -0.01, 0.01)), levels)
    current, direct = np.eye(4), 0
    for i, (corr, iters) in enumerate(zip(MS_PARAMS.voxel_values, MS_PARAMS.iter_values)):
        res = icp.icp(src[-(i + 1)], target_levels[-(i + 1)],
                      multiscale._scale_params(MS_PARAMS, corr, iters), init_transform=current)
        direct += res.num_iterations
        current = res.transformation
    assert counters["icp.iterations"] == direct == spans["icp.iteration"]["count"]
    assert spans["icp.converge"]["count"] == direct - len(MS_PARAMS.voxel_values)
    recs = profiling.records()
    knn = [r for r in recs if r.name.startswith("knn.")]
    assert knn and not any(r.parent and r.parent.startswith("knn.") for r in knn)
    assert {r.parent for r in recs if r.name == "hem.level"} == {"hem.create_mixture"}
    assert {r.parent for r in recs if r.name == "icp.iteration"} == {"icp.run"}
    # One job is two requests: HEM's and the multiscale's.
    assert len({r.request for r in recs}) == 2
    assert counters["knn.pairs"] > 0


def test_knn_pairs_count_the_brute_and_grid_sweeps():
    from gaussiansplattingregistration_tpu_torch.ops import knn

    g = torch.Generator().manual_seed(0)
    q, d = torch.rand(50, 3, generator=g), torch.rand(70, 3, generator=g)
    origin, inv_cell, dims, occ = knn.grid_nn_plan(d, 0.2)
    with profiling.recording():
        knn.knn(q, d, k=4)
        knn.nearest_neighbor(q, d)
        knn.hybrid_search(q, d, 0.1, k=4)
        table = knn.build_grid_table(d, torch.ones(70, dtype=torch.bool), origin, inv_cell,
                                     *dims, occ)
        knn.grid_nearest_neighbor(q, table, origin, inv_cell, *dims, 27 * occ)
        knn.grid_topk(q, table, origin, inv_cell, dims, 4)
    snap = profiling.snapshot()
    assert snap["counters"]["knn.pairs"] == 3 * 50 * 70 + 2 * 50 * 27 * occ
    assert set(snap["spans"]) == {"knn.knn", "knn.nearest", "knn.hybrid", "knn.grid_table",
                                  "knn.grid_nearest", "knn.grid_topk"}
    assert all(r.parent is None for r in profiling.records())


def test_recording_without_a_profiler_and_a_span_closed_by_an_exception():
    assert not torch.autograd._profiler_enabled()
    with profiling.recording():
        with profiling.span("outer"):
            with pytest.raises(RuntimeError):
                with profiling.span("inner"):
                    raise RuntimeError("boom")
            assert profiling.request_id() is not None
            profiling.count("things", 3)
        assert profiling.request_id() is None
    profiling.count("things", 5)                        # off again: not added
    recs = by_name(profiling.records())
    assert recs["inner"][0].parent == "outer"
    assert recs["inner"][0].request == recs["outer"][0].request
    assert profiling.snapshot()["counters"] == {"things": 3}
    with profiling.span("after"):
        pass
    assert "after" not in profiling.snapshot()["spans"]


class _Event:
    """A stand-in CUDA event: `done` says whether the stream has passed it."""

    clock = 0.0
    done = True

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        _Event.clock += 1.5
        self.t = _Event.clock

    def query(self):
        return _Event.done

    def elapsed_time(self, end):
        return end.t - self.t


def test_device_intervals_resolve_wait_and_drop(monkeypatch):
    monkeypatch.setattr(profiling.torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(profiling.torch.cuda, "Event", _Event)
    monkeypatch.setattr(profiling._TRACER, "max_pending", 3)
    monkeypatch.setattr(_Event, "clock", 0.0)
    monkeypatch.setattr(_Event, "done", True)
    with profiling.recording():
        with profiling.span("a"):
            with profiling.span("b"):
                pass
        monkeypatch.setattr(_Event, "done", False)
        snap = profiling.snapshot()
        assert snap["unresolved"] == {"b": 1, "a": 1} and snap["spans"]["a"]["device_s"] == 0.0
        with profiling.span("c"):
            pass
        with profiling.span("d"):                       # past the cap: no events
            pass
    assert profiling.snapshot()["unresolved"] == {"a": 1, "b": 1, "c": 1}
    monkeypatch.setattr(_Event, "done", True)
    snap = profiling.snapshot()
    assert snap["unresolved"] == {} and snap["dropped"] == 1
    # a: recorded at 1.5, b at 3.0 and 4.5, a's end at 6.0 (ms); c: 1.5 ms.
    assert snap["spans"]["a"]["device_s"] == pytest.approx(4.5e-3)
    assert snap["spans"]["b"]["device_s"] == pytest.approx(1.5e-3)
    assert snap["spans"]["c"]["device_s"] == pytest.approx(1.5e-3)
    assert snap["spans"]["d"] == {"count": 1, "host_s": snap["spans"]["d"]["host_s"],
                                  "self_host_s": snap["spans"]["d"]["self_host_s"],
                                  "device_s": 0.0}


# ------------------------------------------------------------ photometric

PHOTOMETRIC_SPANS = {"photometric.step", "photometric.pose", "photometric.merge",
                     "photometric.loss", "photometric.loss_vjp", "photometric.render_vjp",
                     "photometric.adam", "metrics.ssim"}


def refiner(n=300):
    """A photometric refiner on two clouds of `scene` splats, 2 cameras."""
    from gaussiansplattingregistration_tpu_torch.models.camera import Camera
    from gaussiansplattingregistration_tpu_torch.pipelines import photometric

    def cloud(seed):
        g = torch.Generator().manual_seed(seed)
        return GaussianCloud.create(
            torch.randn(n, 3, generator=g) * 0.6 + torch.tensor([0.0, 0.0, 4.0]),
            torch.randn(n, 1, 3, generator=g) * 0.3, torch.randn(n, 3, 3, generator=g) * 0.1,
            torch.randn(n, 1, generator=g), torch.log(torch.rand(n, 3, generator=g) * 0.08 + 0.04),
            torch.randn(n, 4, generator=g), sh_degree=DEG, device="cpu")

    cams = [Camera.create(torch.eye(3), torch.tensor([dx, 0.0, 0.0]), 40.0, 40.0, W, H,
                          device="cpu") for dx in (0.0, 0.3)]
    targets = [torch.rand(H, W, 3, generator=torch.Generator().manual_seed(9)) for _ in cams]
    return photometric.PhotometricRefiner(cloud(1), cams, targets, fixed_cloud=cloud(2),
                                          config=TR.RasterizeConfig(max_splats_per_tile=128),
                                          device="cpu")


def test_a_photometric_step_records_its_spans_and_counters():
    first = refiner()
    off = [first.step() for _ in range(2)]
    r = refiner()
    with profiling.recording():
        on = [r.step() for _ in range(2)]
    assert on == off                                    # the loss is the same
    snap = profiling.snapshot()
    assert PHOTOMETRIC_SPANS <= set(snap["spans"])
    views, steps = len(r.views), 2
    assert snap["counters"]["photometric.views"] == views * steps
    assert snap["counters"]["photometric.pixels"] == W * H * views * steps
    assert snap["counters"]["photometric.splats"] == 600 * steps
    for name in PHOTOMETRIC_SPANS - {"photometric.step", "photometric.adam"}:
        assert snap["spans"][name]["count"] == views * steps, name
    assert snap["spans"]["photometric.step"]["count"] == steps
    recs = by_name(profiling.records())
    steps_ids = {rec.request for rec in recs["photometric.step"]}
    for name in PHOTOMETRIC_SPANS - {"photometric.step"}:
        assert {rec.request for rec in recs[name]} <= steps_ids, name
    assert all(rec.parent == "photometric.step" for rec in recs["photometric.render_vjp"])
    assert all(rec.parent == "photometric.loss" for rec in recs["metrics.ssim"])
    # The rasterizer's backward spans run inside the render VJP's request.
    assert {rec.request for rec in recs["raster.gather_vjp"]} <= steps_ids
