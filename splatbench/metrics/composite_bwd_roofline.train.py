"""composite_bwd's share of its roofline in the train cell, in %: the least
time the backward compositor's work needs (`roofline/composite.py`, from the
reference's binning) over the device time of `composite_bwd_kernel`
(`csrc/composite_bwd.cu` via `ops/raster_cuda.py`) in the traced frames."""

from splatbench.readers import roofline_share

KERNELS = ("composite_bwd_kernel",)


def read(rec):
    return roofline_share(rec, "composite_bwd", KERNELS)
