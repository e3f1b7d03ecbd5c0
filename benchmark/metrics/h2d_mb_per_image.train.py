"""Bytes the prefetch placement sent to the card per image, in MB (10^6
bytes): the program's counters ``data.h2d_bytes`` over ``data.images``,
their parts added in the traced window."""

from benchmark import spans


def read(record: dict):
    sent, images = spans.counter(record, "data.h2d_bytes"), spans.counter(record, "data.images")
    return sent / images / 1e6 if sent and images else None
