"""One reader per per-layer metric, ``<metric name>.py``, found by name: each
defines ``read(record) -> float | None``, taking the run's record (the
harness's clocks and counts, and ``record["trace"]``, the reduced profile),
and returns None when the record holds nothing to read."""
