"""Bytes the engine sent to the card per image served, in MB (10^6 bytes):
the program's counters ``serve.h2d_bytes`` over ``serve.images``, their
parts added in the traced window."""

from benchmark import spans


def read(record: dict):
    sent, images = spans.counter(record, "serve.h2d_bytes"), spans.counter(record, "serve.images")
    return sent / images / 1e6 if sent and images else None
