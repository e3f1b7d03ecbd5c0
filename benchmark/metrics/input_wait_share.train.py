"""The share of the unprofiled window that the training loop spent blocked
in ``next()`` on the prefetched batches (harness clock), in %."""


def read(record: dict):
    if record.get("kind") != "train" or not record.get("window_s"):
        return None
    return 100.0 * record["input_wait_s"] / record["window_s"]
