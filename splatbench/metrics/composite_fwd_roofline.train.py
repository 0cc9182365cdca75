"""composite_fwd's share of its roofline in the train cell, in %: the least
time the forward compositor's work needs (`roofline/composite.py`, from the
reference's binning) over the device time of `composite_fwd_kernel`
(`csrc/composite_fwd.cu` via `ops/raster_cuda.py`) in the traced frames."""

from splatbench.readers import roofline_share

KERNELS = ("composite_fwd_kernel",)


def read(rec):
    return roofline_share(rec, "composite_fwd", KERNELS)
