"""Device milliseconds a photometric step spends posing and merging the
captures and updating the twist: the program's `photometric.pose`
(`se3_exp`, the moving capture's means and covariances),
`photometric.merge` (the concatenation with the fixed capture) and
`photometric.adam` spans (`pipelines/photometric.py`), their device
intervals over a traced step (`splatbench/program_spans.py`)."""

from splatbench.program_spans import device_per_step


def read(rec):
    return device_per_step(rec, "photometric.pose", "photometric.merge", "photometric.adam",
                           scale=1e3)
