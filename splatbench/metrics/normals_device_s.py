"""Device seconds a registration job spends estimating normals: the
program's `normals.estimate` span (`ops/normals.py`: a self-kNN at k=30
and a 3x3 eigendecomposition a point, on every level of both clouds), its
device interval a traced job (`splatbench/program_spans.py`)."""

from splatbench.program_spans import device_per_step


def read(rec):
    return device_per_step(rec, "normals.estimate")
