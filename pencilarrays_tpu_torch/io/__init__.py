"""Parallel I/O (the reference's PencilIO): the raw-binary and HDF5
drivers of the JAX package's ``io/``, reading and writing the same files."""

from .core import ParallelIODriver, metadata, open_file
from .binary import BinaryDriver, BinaryFile
from .orbax_driver import OrbaxDriver, OrbaxFile, has_orbax
from .hdf5 import HDF5Driver, HDF5File, has_hdf5

__all__ = [
    "HDF5Driver",
    "HDF5File",
    "has_hdf5",
    "ParallelIODriver",
    "metadata",
    "open_file",
    "BinaryDriver",
    "BinaryFile",
    "OrbaxDriver",
    "OrbaxFile",
    "has_orbax",
]
