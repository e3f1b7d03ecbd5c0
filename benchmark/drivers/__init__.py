"""One driver per traffic kind, found by the traffic file's ``kind``: each
exposes ``run(run, device)``, which fills the ``harness.Run``."""
