"""What every driver and reader shares: the run's context, spans, the
device trace's reduction, and the numbers compared with their limits."""

from __future__ import annotations

import bisect
import dataclasses
import json
import math
import os
import subprocess
import time
from typing import Callable, Optional

import torch


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


@dataclasses.dataclass
class Context:
    """One run: the cell, its configuration and traffic, the device, the
    seed, and the control to put in the program's place (None for the
    program itself)."""

    cell: dict
    config: dict
    traffic: dict
    device: torch.device
    seed: int
    control: Optional[str] = None

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class Spans:
    """Host-clock spans by name, each ending in a synchronize."""

    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.seconds: dict[str, list[float]] = {}

    def run(self, name: str, fn: Callable, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        self.ctx.sync()
        self.seconds.setdefault(name, []).append(time.perf_counter() - t0)
        return out


def quantile(values, q: float) -> float:
    """The q-quantile of `values` (linear between order statistics)."""
    v = sorted(values)
    if len(v) == 1:
        return v[0]
    pos = q * (len(v) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e!r}"
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------ the trace


def reduce_trace(prof, window_s: float) -> dict:
    """The device trace of a profiled window, reduced: `busy_s` (the union
    of the device operations' intervals), `window_s`, `kernels` {name:
    device seconds}, `device_ops` (the ten names that took most), and
    `idle_gaps` (device idle time by the innermost host operation running
    at each gap's midpoint, the ten largest)."""
    from torch.autograd import DeviceType

    dev_iv, cpu_iv = [], []
    for ev in prof.events():
        tr = ev.time_range
        if ev.device_type == DeviceType.CUDA:
            dev_iv.append((tr.start, tr.end, ev.name))
        elif ev.device_type == DeviceType.CPU:
            cpu_iv.append((tr.start, tr.end, ev.name))
    dev_iv.sort()
    kernels: dict[str, float] = {}
    busy = 0.0
    gaps = []
    cur_s = cur_e = None
    for s, e, name in dev_iv:
        kernels[name] = kernels.get(name, 0.0) + (e - s) * 1e-6
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    idle: dict[str, float] = {}
    cpu_iv.sort()
    starts = [c[0] for c in cpu_iv]
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        label = "python"
        # The innermost host operation holding the midpoint: host operations
        # nest, so it is the latest to start among those still running.
        last = bisect.bisect_right(starts, mid) - 1
        for i in range(last, max(last - 4096, -1), -1):
            if cpu_iv[i][1] >= mid:
                label = cpu_iv[i][2]
                break
        idle[label] = idle.get(label, 0.0) + (g1 - g0) * 1e-6
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy * 1e-6, "window_s": window_s, "kernels": kernels,
            "device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps_top]}


def kernel_seconds(trace: dict, names) -> Optional[float]:
    """Device seconds of the kernels whose name contains one of `names`, or
    None where none ran."""
    if not trace:
        return None
    hits = [v for k, v in trace["kernels"].items() if any(n in k for n in names)]
    return sum(hits) if hits else None


# ------------------------------------------------------- compared numbers


@dataclasses.dataclass
class Compared:
    """One number held against its limit: above it fails (`upper`), or
    below it fails (not `upper`)."""

    name: str
    value: float
    limit: float
    upper: bool = True

    @property
    def ok(self) -> bool:
        if self.value is None or (isinstance(self.value, float) and math.isnan(self.value)):
            return False
        return self.value <= self.limit if self.upper else self.value >= self.limit

    def line(self) -> str:
        rel = "<=" if self.upper else ">="
        return f"{self.name} {self.value!r} (limit {rel} {self.limit!r}) {'ok' if self.ok else 'FAIL'}"


def held(values: dict, limits: dict) -> list[Compared]:
    """Each number of `values` named in `limits` ({name: [direction,
    limit]}, direction "max" or "min"), in the order of `limits`. A number
    that `limits` names and the run did not produce fails."""
    out = []
    for name, (direction, limit) in limits.items():
        out.append(Compared(name, values.get(name, float("nan")), float(limit),
                            upper=direction == "max"))
    return out
