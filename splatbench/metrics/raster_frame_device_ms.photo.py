"""Device milliseconds a photometric step spends in the rasterizer's
forward: the program's `raster.frame` span (`ops/rasterize.py`:
projection, SH, the tile table, the gather and the forward compositor)
over every view of a traced step, its device interval, idle inside it
included (`splatbench/program_spans.py`)."""

from splatbench.program_spans import device_per_step


def read(rec):
    return device_per_step(rec, "raster.frame", scale=1e3)
