"""Host time per traced micro-step in ``autograd.grad`` (``train.backward``):
the program's span totals in the traced window over its ``train.step``
spans, in ms."""

from benchmark import spans


def read(record: dict):
    return spans.per_step_ms(record, "train.backward")
