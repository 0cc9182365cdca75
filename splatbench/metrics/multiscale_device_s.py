"""Device seconds a registration job spends in multiscale ICP: the
program's `multiscale.register` span (`pipelines/multiscale.py`, with the
levels' normals and ICP inside), its device interval a traced job; close
to busy time in this device-bound cell (`splatbench/program_spans.py`)."""

from splatbench.program_spans import device_per_step


def read(rec):
    return device_per_step(rec, "multiscale.register")
