"""Seconds a job spends in `pipelines/multiscale.py` (with `ops/icp.py`,
`knn.py`, `voxel.py`, `normals.py`), the mean of the window's benchmark
spans around the multiscale call, each ending with the pose on the host."""

from splatbench.readers import span_mean


def read(rec):
    return span_mean(rec, "multiscale")
