"""Device milliseconds a photometric step spends on its loss: the
program's `photometric.loss` (clip, L1 and SSIM's forward, `metrics.ssim`
inside it) and `photometric.loss_vjp` (the loss's VJP to the rendered
image) spans (`pipelines/photometric.py`), their device intervals over
every view of a traced step (`splatbench/program_spans.py`)."""

from splatbench.program_spans import device_per_step


def read(rec):
    return device_per_step(rec, "photometric.loss", "photometric.loss_vjp", scale=1e3)
