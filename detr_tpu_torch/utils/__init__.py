"""Host utilities of the port: tracing and step timing, tensorboard logging,
and walks over nested tensors (``trees``)."""
