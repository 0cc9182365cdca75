"""Device milliseconds a photometric step spends carrying the rendered
images' cotangents back to the twist: the program's
`photometric.render_vjp` span (`pipelines/photometric.py`: the
rasterizer's backward, the merge's and the pose chain's), its device
interval over every view of a traced step (`splatbench/program_spans.py`)."""

from splatbench.program_spans import device_per_step


def read(rec):
    return device_per_step(rec, "photometric.render_vjp", scale=1e3)
