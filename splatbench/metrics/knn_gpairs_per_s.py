"""Billions of query-candidate pairs a device second of neighbour search:
the program's `knn.pairs` counter (Q·N for a brute sweep, Q·W for a grid
window, from host shapes) over the device intervals of every `knn.*` span
in the traced jobs (`splatbench/program_spans.py`)."""

from splatbench.program_spans import counter, device_s


def read(rec):
    pairs = counter(rec, "knn.pairs")
    seconds = device_s(rec, "knn.")
    if pairs is None or not seconds:
        return None
    return pairs / seconds / 1e9
