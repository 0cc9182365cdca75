"""Host milliseconds a forward render spends inside the rasterizer: the
program's `raster.frame` span (`ops/rasterize.py`, from the call until it
returns, without a synchronize) a traced render; set beside the device's
busy time a render, it says how far the host holds the card back
(`splatbench/program_spans.py`)."""

from splatbench.program_spans import host_per_step


def read(rec):
    return host_per_step(rec, "raster.frame", scale=1e3)
