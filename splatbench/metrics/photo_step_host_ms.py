"""Host milliseconds of a photometric step: the program's
`photometric.step` span (`pipelines/photometric.py`, one Adam step over
every view, the per-view loss reads included), a traced step
(`splatbench/program_spans.py`)."""

from splatbench.program_spans import host_per_step


def read(rec):
    return host_per_step(rec, "photometric.step", scale=1e3)
