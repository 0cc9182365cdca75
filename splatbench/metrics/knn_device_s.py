"""Device seconds a registration job spends in neighbour search: every
`knn.*` span of `ops/knn.py` (HEM's candidates, the levels' normals, ICP's
correspondences; no `knn.*` span opens inside another), their device
intervals a traced job (`splatbench/program_spans.py`)."""

from splatbench.program_spans import device_per_step


def read(rec):
    return device_per_step(rec, "knn.")
