"""One module per per-layer metric: ``UNIT`` and ``read(window)``, which
returns the metric's value from a traced window (``harness.Window``), or
``None`` where the window holds nothing it reads."""
