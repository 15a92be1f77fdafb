"""The Orbax/TensorStore checkpoint driver of the JAX package — not ported.

Orbax exists only in JAX's world.  ``torch.distributed.checkpoint`` is the
PyTorch analog (sharded, async-capable, directory per checkpoint), but its
files are not Orbax's, so a driver over it cannot meet the contract every
other driver of the port keeps: files that the JAX package reads back.
:func:`has_orbax` is therefore False, and :class:`OrbaxDriver` and
:class:`OrbaxFile` raise, naming the ROADMAP item that holds the driver.
"""

from __future__ import annotations

from .core import ParallelIODriver

__all__ = ["OrbaxDriver", "OrbaxFile", "has_orbax"]

_LATER = ("not ported yet: ROADMAP.md Queue 1, item 6, the Orbax driver "
          "(its analog, torch.distributed.checkpoint, writes files the JAX "
          "package cannot read); use BinaryDriver or HDF5Driver")


def has_orbax() -> bool:
    """Always False: the port has no Orbax driver."""
    return False


class OrbaxDriver(ParallelIODriver):
    """Placeholder of the JAX package's ``OrbaxDriver``: raises."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"OrbaxDriver is {_LATER}")


class OrbaxFile:
    """Placeholder of the JAX package's ``OrbaxFile``: raises."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"OrbaxFile is {_LATER}")
