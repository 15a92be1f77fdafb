"""One module per kind of cell: ``setup(config, params, seed, device,
control=False)`` returns a cell whose ``warmup()``, ``step()``,
``release()`` and ``check()`` the harness calls (see ``harness.py``)."""
