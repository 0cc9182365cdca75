"""Seconds a job spends in `ops/hem.py`'s `create_mixture` (three levels),
the mean of the window's benchmark spans, each ending in a synchronize."""

from splatbench.readers import span_mean


def read(rec):
    return span_mean(rec, "hem")
