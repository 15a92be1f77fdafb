"""The repo's user entry points on the port: each of the JAX package's
``examples/*.py`` as a module with ``run(device=None, **sizes) -> dict``
(what the JAX script prints or asserts) and ``main(argv=None)``::

    python -m pencilarrays_tpu_torch.examples.<name> [--device cpu]
        [--ranks N] [--<size> VALUE ...]

Each runs on the card unless the CPU is named, on N ranks over NCCL
(N cards) or gloo (``--device cpu``); see :mod:`._launch`.
"""

EXAMPLES = ("quickstart", "gradient_spectral", "navier_stokes",
            "adjoint_optimization", "heat_stencil", "checkpoint_collections",
            "observability_demo", "sequence_parallel_attention",
            "long_context_training")
