"""Real images per forward over the engine's batch (padded rows are
waste), in %."""


def read(record: dict):
    if not record.get("forwards") or not record.get("batch_size"):
        return None
    return 100.0 * record["requests"] / (record["forwards"] * record["batch_size"])
