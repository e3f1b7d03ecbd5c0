"""The multi-scale deformable attention kernels' share of their roofline:
the least time of the MSDA work the traced calls asked for (forward and
backward, ``flops_deformable.msda_bounds``), over the device time of the
kernels launched under the program's ``msda`` span and autograd's
``MSDeformAttnBackward`` node, in %."""


def read(record: dict):
    if not record.get("msda_device_s") or not record.get("msda_bound_s"):
        return None
    return 100.0 * record["msda_bound_s"] / record["msda_device_s"]
