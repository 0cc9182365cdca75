"""Device milliseconds a frame of every device operation other than the
composite kernels in the view cell: projection, SH, the tile table, the
gather and (in training) their backward (`ops/rasterize.py`)."""

from splatbench.readers import other_device_ms_per_step

COMPOSITE_KERNELS = ("composite_fwd_kernel", "composite_bwd_kernel")


def read(rec):
    return other_device_ms_per_step(rec, COMPOSITE_KERNELS)
