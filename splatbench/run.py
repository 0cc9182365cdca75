"""Runs one cell of BENCHMARK.json once and prints one JSON result line.

    python3 splatbench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout that holds BENCHMARK.json, this folder and the
PyTorch/CUDA package. The cell names its configuration
(`configs/<config>.json`) and its traffic mix (`traffic/<mix>.json`); the
mix names its driver (`drivers/<driver>.py`: `setup`, `step`,
`window_metrics`, `spans`, `check`, and optionally `traced_step`, `work`
and `release`), and each per-layer metric is read by
`metrics/<metric>.py`. Everything is found by name.

A run: set-up (the scene from the seed, the configuration's gates, the
warm-up of every shape the traffic uses), then a closed-loop window of
`--seconds` ending in a synchronize, then with `--trace 1` a short
profiled window, then the check of the window's outputs against the plain
reference under `reference/`. `--trace 0` prints the cell's end-to-end
metrics, `--trace 1` its per-layer metrics. Every number compared is
printed beside its limit, last on standard error and last in the result
line. Without a card it exits 2 and prints no result; `--device cpu` runs
on the CPU for the tests, whose tiny cells are files of their own.
`--control NAME` puts a lower-precision stand-in in the program's place
(see the drivers); the benchmark's own runs never pass it.
"""

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "splatbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "gaussiansplattingregistration_tpu")


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _fail(msg: str, code: int = 1) -> int:
    print(f"splatbench: {msg}", file=sys.stderr, flush=True)
    return code


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (the part before the first dot, compared whole)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _env() -> None:
    """Caches at fixed paths inside the checkout; no JAX through transformers;
    few host threads, so the one process's load stays steady."""
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, ".splatbench_cache", "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "2")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default), or cpu for the tests")
    ap.add_argument("--control", default=None, help="a stand-in for the program (see drivers)")
    args = ap.parse_args(argv)
    _env()
    sys.path.insert(0, ROOT)

    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        return _fail(f"no workload {args.workload!r} in BENCHMARK.json")
    cell = cells[args.workload]

    import torch

    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
    if args.device == "cuda":
        if not torch.cuda.is_available():
            return _fail("no CUDA device is available", 2)
        if torch.cuda.device_count() < int(cell["chips"]):
            return _fail(f"{cell['name']} needs {cell['chips']} cards, "
                         f"{torch.cuda.device_count()} present", 2)
    dev = torch.device(args.device)

    from splatbench import common

    config = common.load_json(BENCH, "configs", cell["config"] + ".json")
    traffic = common.load_json(BENCH, "traffic", cell["traffic"] + ".json")
    driver = _load(os.path.join(BENCH, "drivers", traffic["driver"] + ".py"),
                   "splatbench_driver_" + traffic["driver"])
    ctx = common.Context(cell=cell, config=config, traffic=traffic, device=dev, seed=args.seed,
                         control=args.control)
    card = common.card_line() if dev.type == "cuda" else "cpu"
    print(f"# {cell['name']} seed {args.seed} on {card}", file=sys.stderr, flush=True)

    state = driver.setup(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - _T_START

    steps = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        driver.step(state, steps)
        steps += 1
    ctx.sync()
    window_s = time.perf_counter() - t0
    e2e = driver.window_metrics(state, window_s, steps)
    e2e["setup_s"] = setup_s
    spans = driver.spans(state)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    print(f"# window: {steps} steps in {window_s!r} s; {e2e}", file=sys.stderr, flush=True)
    if dev.type == "cuda":
        stats = torch.cuda.memory_stats(dev)
        print("# allocator: " + json.dumps({k: stats.get(k) for k in (
            "num_alloc_retries", "num_device_alloc", "num_device_free", "num_ooms")}),
              file=sys.stderr, flush=True)

    trace = {}
    if args.trace:
        trace = _traced_window(driver, state, ctx, steps)
    if hasattr(driver, "release"):
        driver.release(state)
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    rec = {"cell": cell, "config": config, "traffic": traffic, "spans": spans, "trace": trace,
           "window_s": window_s, "steps": steps}
    if args.trace and dev.type == "cuda":
        from splatbench.roofline import composite as roofline

        if hasattr(driver, "work"):
            rec["work"] = driver.work(state, roofline.peaks(torch.cuda.get_device_name(dev)))

    numbers = driver.check(state)
    limits = {**config.get("stated_limits", {}), **traffic["limits"]}
    compared = common.held(numbers, limits)
    correct = all(c.ok for c in compared)
    others = {k: v for k, v in numbers.items() if k not in limits}

    if args.trace:
        metrics = _per_layer(bench, cell, rec)
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in bench["end_to_end"] if m["name"] in e2e
                   and cell["name"] in m.get("workloads", [cell["name"]])}

    found = forbidden_modules()
    if found:
        return _fail(f"forbidden modules loaded: {found}")

    device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    if args.trace and trace:
        device["busy_s"] = trace["busy_s"]
        device["window_s"] = trace["window_s"]
    result = {"correct": correct, "attempted": steps, "failed": 0, "metrics": metrics,
              "device": device, "card": card}
    if args.trace and trace:
        result["breakdown"] = {"device_ops": trace["device_ops"], "idle_gaps": trace["idle_gaps"]}
    result["reported"] = others
    result["compared"] = {c.name: {"value": c.value, "limit": c.limit,
                                   "fails_if": "above" if c.upper else "below"}
                          for c in compared}
    for c in compared:
        print(f"# compared: {c.line()}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def _traced_window(driver, state, ctx, first: int) -> dict:
    """`trace_steps` steps under torch.profiler, ending in a synchronize,
    reduced to the device's busy time, kernel times and idle gaps."""
    import torch

    from splatbench import common

    acts = [torch.profiler.ProfilerActivity.CPU]
    if ctx.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        traced_step = getattr(driver, "traced_step", driver.step)
        for i in range(int(ctx.traffic["trace_steps"])):
            traced_step(state, first + i)
        ctx.sync()
        window_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    out = common.reduce_trace(prof, window_s)
    print(f"# traced window {window_s!r} s, busy {out['busy_s']!r} s, reduced in "
          f"{time.perf_counter() - t1:.1f} s", file=sys.stderr, flush=True)
    if ctx.device.type != "cuda" or out["busy_s"] <= 0:
        return {}
    return out


def _per_layer(bench: dict, cell: dict, rec: dict) -> dict:
    """Each per-layer metric whose cells include this one, from its reader;
    a reader that finds nothing returns None and the metric is left out."""
    e2e_here = {m["name"] for m in bench["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])}
    out = {}
    for m in bench["per_layer"]:
        if cell["name"] not in m.get("workloads", [cell["name"]]) or m["moves"] not in e2e_here:
            continue
        reader = _load(os.path.join(BENCH, "metrics", m["name"] + ".py"),
                       "splatbench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


if __name__ == "__main__":
    sys.exit(main())
