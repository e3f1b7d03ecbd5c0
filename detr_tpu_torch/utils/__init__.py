"""Host utilities of the port: tracing and step timing, tensorboard logging,
walks over nested tensors (``trees``), the host's RSS (``host``) and the
progress watchdog (``watchdog``)."""
