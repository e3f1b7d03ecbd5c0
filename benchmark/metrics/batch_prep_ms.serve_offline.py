"""Host time per device batch between the transforms and the forward: the
program's ``serve.assemble`` (the float32 canvas and the copy into it) and
``serve.h2d`` (the copies to the card) spans in the traced window, over
the batches assembled, in ms."""

from benchmark import spans


def read(record: dict):
    assembled, n = spans.total_s(record, "serve.assemble")
    copied, _ = spans.total_s(record, "serve.h2d")
    return 1e3 * (assembled + copied) / n if n else None
