"""The device's idle share of the traced window in the photometric cell,
in %: the window less the union of the device operations' intervals."""

from splatbench.readers import idle_pct


def read(rec):
    return idle_pct(rec)
