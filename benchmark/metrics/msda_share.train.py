"""The multi-scale deformable attention kernels' share of the device's
busy time in the traced window: the device time of the kernels launched
under the program's ``msda`` span and autograd's ``MSDeformAttnBackward``
node, over the union of the window's kernel, copy and fill intervals, in
%."""


def read(record: dict):
    t = record.get("trace")
    if not t or not t["busy_s"] or not record.get("msda_device_s"):
        return None
    return 100.0 * record["msda_device_s"] / t["busy_s"]
