"""composite_bwd's share of its roofline in the photometric cell, in %:
the least time the backward compositor's work needs over every view of the
traced steps (`roofline/composite.py`, from the reference's binning at each
step's pose; `drivers/photometric.py::work`) over the device time of
`composite_bwd_kernel` (`csrc/composite_bwd.cu` via `ops/raster_cuda.py`)."""

from splatbench.readers import roofline_share

KERNELS = ("composite_bwd_kernel",)


def read(rec):
    return roofline_share(rec, "composite_bwd", KERNELS)
