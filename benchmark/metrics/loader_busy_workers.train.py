"""How many loader workers were busy on average over the traced window: the
summed time of the program's ``data.load`` spans (one per item, stamped in
the worker: decode, augment, bucket fit), clipped to the window, over the
window (2.0: both workers always busy)."""

from benchmark import spans


def read(record: dict):
    w = spans.window(record)
    if w is None:
        return None
    busy, n = spans.total_s(record, "data.load", thread=False)
    return busy * 1e9 / (w[1] - w[0]) if n else None
