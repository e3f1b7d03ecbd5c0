"""The share of the traced window that the training loop spent in the
program's ``data.wait`` spans (the consumer's wait for a prefetched batch
and its ``take``, on the loop's thread), in %."""

from benchmark import spans


def read(record: dict):
    w = spans.window(record)
    if w is None:
        return None
    waited, n = spans.total_s(record, "data.wait")
    return 100.0 * waited * 1e9 / (w[1] - w[0]) if n else None
