"""Device seconds a registration job spends in HEM: the program's
`hem.create_mixture` span (`ops/hem.py`), its device interval summed over
the traced jobs and divided by them. The cell is device-bound, so the
interval is close to HEM's busy time (`splatbench/program_spans.py`)."""

from splatbench.program_spans import device_per_step


def read(rec):
    return device_per_step(rec, "hem.create_mixture")
