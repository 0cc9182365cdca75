"""Device milliseconds a photometric step spends binning: the program's
`raster.bin` span (`_build_tile_table` in `ops/rasterize.py`) over every
view of a traced step, its device interval, idle inside it included
(`splatbench/program_spans.py`)."""

from splatbench.program_spans import device_per_step


def read(rec):
    return device_per_step(rec, "raster.bin", scale=1e3)
