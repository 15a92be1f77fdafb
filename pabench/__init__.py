"""The benchmark of ``pencilarrays_tpu_torch`` on an NVIDIA card.

One command runs one cell once::

    python3 pabench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything here is found by name, so a new cell, configuration or
per-layer metric is a new file and no edit:

* ``configs/<name>.json``: a deployment's sizes, its source and cuts;
* ``workloads/<name>.json``: a cell: its configuration, its driver, the
  parameters of its inputs and the limit of every number it compares;
* ``drivers/<kind>.py``: builds the program's state from the seed, runs
  one unit of work, and compares what the window produced with
  ``reference/<kind>.py``, a plain PyTorch version that imports nothing
  of the program;
* ``metrics/<name>.py``: reads one per-layer metric from the traced
  window (kernel times by the groups of ``data/kernel_groups.json``, the
  program's counters, the peaks of ``data/peaks.json``).

Nothing here imports ``jax`` or the JAX package ``pencilarrays_tpu``.
"""
