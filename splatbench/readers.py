"""What the per-layer readers under `metrics/` share. A reader takes the
run's record: `spans` (host seconds by span name, from the untraced
window), `trace` (the profiled window reduced by `common.reduce_trace`,
empty where no device operation was traced), `work` (the least device
seconds of each kernel's work over the traced steps, from `roofline/`),
`steps` and `window_s`. It returns a number, or None where it finds
nothing to read."""

from __future__ import annotations

from splatbench.common import kernel_seconds


def roofline_share(rec: dict, kernel: str, names) -> float | None:
    """The kernel's share of its roofline, in %: the least time its work
    needs over the device time of the kernels named `names`."""
    bound = (rec.get("work") or {}).get(kernel)
    device = kernel_seconds(rec.get("trace"), names)
    if not bound or not device:
        return None
    return 100.0 * bound / device


def other_device_ms_per_step(rec: dict, exclude) -> float | None:
    """Device milliseconds per traced step of every device operation whose
    name contains none of `exclude`."""
    trace = rec.get("trace")
    steps = int(rec["traffic"]["trace_steps"])
    if not trace or not steps:
        return None
    total = sum(v for k, v in trace["kernels"].items() if not any(e in k for e in exclude))
    return 1e3 * total / steps


def idle_pct(rec: dict) -> float | None:
    """The device's idle share of the traced window, in %."""
    trace = rec.get("trace")
    if not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def span_mean(rec: dict, name: str) -> float | None:
    values = rec["spans"].get(name)
    return sum(values) / len(values) if values else None
