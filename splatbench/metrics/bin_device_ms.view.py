"""Device milliseconds a forward render spends binning: the program's
`raster.bin` span (`_build_tile_table` in `ops/rasterize.py`: entries, the
fused-key sort, the tile table), its device interval a traced render. The
render cell is host-bound, so the interval is the stage's share of the
device timeline, idle inside it included (`splatbench/program_spans.py`)."""

from splatbench.program_spans import device_per_step


def read(rec):
    return device_per_step(rec, "raster.bin", scale=1e3)
