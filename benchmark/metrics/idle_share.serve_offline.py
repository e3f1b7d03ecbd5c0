"""The device's idle share of the traced window: 1 - the union of its
kernel, copy and fill intervals over the window's length, in %."""

from benchmark.metrics._share import idle_share


def read(record: dict):
    return idle_share(record)
