"""The median forward render of the view cell's window, in ms, each timed
from its call to a synchronize: the steady middle beside the tail."""

import statistics


def read(rec):
    values = rec["spans"].get("render")
    return 1e3 * statistics.median(values) if values else None
