"""The 95th percentile of the view cell's forward renders in the window,
in ms, each timed from its call to a synchronize: the tail a viewer
feels, beside `render_mean_ms`. It follows the host's stalls more than
the mean does (PERF.md §2)."""

from splatbench.common import quantile


def read(rec):
    values = rec["spans"].get("render")
    return 1e3 * quantile(values, 0.95) if values else None
