"""composite_fwd's share of its roofline in the photometric cell, in %:
the least time the forward compositor's work needs over every view of the
traced steps (`roofline/composite.py`, from the reference's binning at each
step's pose; `drivers/photometric.py::work`) over the device time of
`composite_fwd_kernel` (`csrc/composite_fwd.cu` via `ops/raster_cuda.py`)."""

from splatbench.readers import roofline_share

KERNELS = ("composite_fwd_kernel",)


def read(rec):
    return roofline_share(rec, "composite_fwd", KERNELS)
