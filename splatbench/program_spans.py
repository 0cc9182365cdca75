"""What the readers of the program's own spans and counters share. The
port records them (`gaussiansplattingregistration_tpu_torch/utils/
profiling.py`) only while tracing is on, and in a run only the traced
window runs under a profiler: set-up, the untraced window and the check
record nothing. So `snapshot()` read after the run covers the traced
window, and a reader divides by the traffic's `trace_steps`.

A reader returns None where the traced window holds no device trace (on
the CPU), where the program has no snapshot to read (a version of it
without spans), and where its span or counter was not recorded or some of
its device intervals had not resolved.

A span's device interval runs from the stream reaching the span's start
until it passes its end, so it holds the device's idle time inside the
span: close to busy time where the device is the bottleneck, the stage's
share of the device timeline where the host is."""

from __future__ import annotations


def snapshot(rec: dict) -> dict | None:
    """The program's snapshot of the traced window, or None."""
    if not rec.get("trace"):
        return None
    try:
        from gaussiansplattingregistration_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "snapshot", None)
    return read() if read is not None else None


def _steps(rec: dict) -> int:
    return int(rec["traffic"]["trace_steps"])


def _spans(snap: dict | None, names) -> list | None:
    """The snapshot's entries of `names` (prefixes where a name ends in
    "."), or None where one is missing or any of them is unresolved."""
    if snap is None:
        return None
    found = []
    for name in names:
        hits = ([v for k, v in snap["spans"].items() if k.startswith(name)]
                if name.endswith(".") else [snap["spans"][name]] if name in snap["spans"] else [])
        if not hits:
            return None
        found += hits
    pending = [k for k in snap["unresolved"]
               if any(k.startswith(n) if n.endswith(".") else k == n for n in names)]
    return None if pending else found


def device_s(rec: dict, *names) -> float | None:
    """The device seconds of the spans `names` over the traced window."""
    snap = snapshot(rec)
    found = _spans(snap, names)
    if found is None or snap["dropped"]:
        return None
    return sum(v["device_s"] for v in found)


def device_per_step(rec: dict, *names, scale: float = 1.0) -> float | None:
    total = device_s(rec, *names)
    return None if total is None else scale * total / _steps(rec)


def host_per_step(rec: dict, *names, scale: float = 1.0) -> float | None:
    """The host seconds of the spans `names` a traced step, times `scale`."""
    found = _spans(snapshot(rec), names)
    if found is None:
        return None
    return scale * sum(v["host_s"] for v in found) / _steps(rec)


def counter(rec: dict, name: str) -> float | None:
    """The counter `name` over the traced window."""
    snap = snapshot(rec)
    if snap is None or name not in snap["counters"]:
        return None
    return float(snap["counters"][name])


def counter_per_step(rec: dict, name: str) -> float | None:
    total = counter(rec, name)
    return None if total is None else total / _steps(rec)
