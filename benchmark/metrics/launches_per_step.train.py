"""Kernel launches per micro-step in the profiled micro-steps."""


def read(record: dict):
    t = record.get("trace")
    if not t or not record.get("profiled_micro_steps"):
        return None
    return t["kernels"] / record["profiled_micro_steps"]
