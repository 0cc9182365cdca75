"""ICP updates a registration job makes over its scales: the program's
`icp.iterations` counter (`ops/icp.py`, the loop's own count), over the
traced jobs (`splatbench/program_spans.py`)."""

from splatbench.program_spans import counter_per_step


def read(rec):
    return counter_per_step(rec, "icp.iterations")
