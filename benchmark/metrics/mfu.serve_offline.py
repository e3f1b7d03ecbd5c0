"""The whole step's share of the chip's peak: the benchmark's FLOP count of
the model at each batch's canvas (x3 when training) over the unprofiled
window of the traced run, over the published bf16 peak, in %."""

from benchmark.metrics._share import mfu


def read(record: dict):
    return mfu(record)
