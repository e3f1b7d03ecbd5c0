"""The median wait of a request between when it was due and when
``predict`` began on it (harness clock), in ms."""

from statistics import median


def read(record: dict):
    waits = record.get("queue_waits_s")
    if not waits:
        return None
    return 1e3 * median(waits)
