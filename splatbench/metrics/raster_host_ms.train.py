"""Host milliseconds a training frame spends in the rasterizer: the
program's `raster.frame` span (the forward) and the backward's
`raster.gather_vjp` and `raster.composite_vjp` spans (`ops/rasterize.py`,
`ops/raster_cuda.py`), a traced frame (`splatbench/program_spans.py`).
Autograd's backward of projection and SH has no span and is not here."""

from splatbench.program_spans import host_per_step


def read(rec):
    return host_per_step(rec, "raster.frame", "raster.gather_vjp", "raster.composite_vjp",
                         scale=1e3)
