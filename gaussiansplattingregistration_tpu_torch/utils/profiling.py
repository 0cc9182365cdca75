"""Tracing/profiling helpers on `torch.profiler`.

Torch counterpart of `gaussiansplattingregistration_tpu/utils/profiling.py`:
a device trace with one flag, named spans, and wall-clock phase timing that
waits for the card where asked.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch


def _sync(tree) -> None:
    """Wait for the CUDA devices of every tensor in a nested dict / list /
    tuple (the counterpart of `jax.block_until_ready`)."""
    if torch.is_tensor(tree):
        if tree.is_cuda:
            torch.cuda.synchronize(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _sync(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _sync(v)


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """A `torch.profiler` trace of the block (CPU, and CUDA when a card is
    present), exported to `log_dir` as a Chrome/TensorBoard trace file;
    no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ):
        yield


@contextlib.contextmanager
def annotate(name: str):
    """Named span visible in profiler timelines."""
    with torch.profiler.record_function(name):
        yield


class Stopwatch:
    """Accumulating phase timer: `with sw("project"): ...`; `.summary()`.
    With `block_on`, a phase ends when the card has finished the tensors
    given."""

    def __init__(self):
        self._acc: Dict[str, float] = {}
        self._count: Dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _sync(block_on)
            dt = time.perf_counter() - t0
            self._acc[name] = self._acc.get(name, 0.0) + dt
            self._count[name] = self._count.get(name, 0) + 1

    def summary(self) -> Dict[str, dict]:
        return {
            k: {"total_s": round(v, 4), "count": self._count[k],
                "mean_ms": round(v / self._count[k] * 1000, 3)}
            for k, v in self._acc.items()
        }


def timed(fn, *args, iters: int = 5, warmup: int = 1):
    """Steady-state wall time of `fn(*args)`, ending at a sync of the
    output's CUDA devices: returns (seconds per call, output)."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _sync(out)
    return (time.perf_counter() - t0) / iters, out
