"""Host utilities of the port: tracing and step timing, tensorboard logging,
walks over nested tensors (``trees``), the host's RSS (``host``), the
progress watchdog (``watchdog``), sharing the card with a benchmark
(``chip_pause``) and the lazy g++ build of the host C++ libraries
(``native_build``)."""
