"""Structured logging + progress reporting.

The port's own copy of `gaussiansplattingregistration_tpu/utils/logging.py`,
which imports no JAX:

* `RunLogger` writes JSONL event records (one dict per line, timestamped)
  — per-step metrics (fitness, RMSE, photometric loss, PSNR) and phase marks;
* `ProgressReporter` is a callback channel any long op accepts
  (`progress_callback=`), with cooperative cancellation between chunked
  device dispatches.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Callable, Optional

logger = logging.getLogger("gsr_torch")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


class RunLogger:
    """JSONL event log: one record per line with wall-clock timestamps."""

    def __init__(self, path: Optional[str] = None, echo: bool = False):
        self._f = open(path, "a") if path else None
        self._echo = echo
        self._t0 = time.time()

    def log(self, event: str, **fields) -> None:
        record = {"t": round(time.time() - self._t0, 4), "event": event, **fields}
        line = json.dumps(record)
        if self._f:
            self._f.write(line + "\n")
            self._f.flush()
        if self._echo:
            logger.info(line)

    def metrics(self, step: int, **metrics) -> None:
        self.log("metrics", step=step, **metrics)

    def phase(self, name: str, **fields) -> "PhaseTimer":
        return PhaseTimer(self, name, fields)

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None


class PhaseTimer:
    """Context manager logging phase duration."""

    def __init__(self, run_logger: RunLogger, name: str, fields: dict):
        self._logger = run_logger
        self._name = name
        self._fields = fields

    def __enter__(self):
        self._start = time.perf_counter()
        self._logger.log("phase_start", phase=self._name, **self._fields)
        return self

    def __exit__(self, exc_type, exc, tb):
        self._logger.log(
            "phase_end",
            phase=self._name,
            seconds=round(time.perf_counter() - self._start, 4),
            error=repr(exc) if exc else None,
            **self._fields,
        )
        return False


class CancelledError(RuntimeError):
    """Raised by ProgressReporter.checkpoint() after cancel()."""


class ProgressReporter:
    """Progress callback + cooperative cancellation between device dispatches.

    Long-running operations call `report(percent)` at phase boundaries and
    `checkpoint()` between chunked dispatches; a controller (another thread,
    signal handler, UI) may call `cancel()`.
    """

    def __init__(self, callback: Optional[Callable[[int], None]] = None):
        self._callback = callback
        self._cancelled = False
        self.percent = 0

    def report(self, percent: int) -> None:
        self.percent = int(percent)
        if self._callback is not None:
            self._callback(self.percent)

    def cancel(self) -> None:
        self._cancelled = True

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    def checkpoint(self) -> None:
        if self._cancelled:
            raise CancelledError("operation cancelled")
