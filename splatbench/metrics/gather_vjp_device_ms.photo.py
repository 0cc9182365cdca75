"""Device milliseconds a photometric step spends landing the per-entry
cotangents on their splats: the program's `raster.gather_vjp` span
(`_GatherEntries.backward` in `ops/rasterize.py`) over every view of a
traced step, its device interval, idle inside it included
(`splatbench/program_spans.py`)."""

from splatbench.program_spans import device_per_step


def read(rec):
    return device_per_step(rec, "raster.gather_vjp", scale=1e3)
