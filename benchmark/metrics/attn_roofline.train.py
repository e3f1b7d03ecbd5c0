"""The attention kernels' share of their roofline: the least time of the
attention work the traced calls asked for (forward, and backward when
training; ``flops.attention_bounds``), over the device time of the kernels
launched under the harness's attention span and autograd's attention
backward node, in %."""

from benchmark.metrics._share import attention_roofline


def read(record: dict):
    return attention_roofline(record)
