"""Host time per image of the engine's transform and bucket fit: the
program's ``serve.transform`` spans in the traced window, their total over
their count, in ms."""

from benchmark import spans


def read(record: dict):
    took, n = spans.total_s(record, "serve.transform")
    return 1e3 * took / n if n else None
