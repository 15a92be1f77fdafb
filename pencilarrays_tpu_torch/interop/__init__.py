"""Conversion of state between the JAX package and the port, and the
global norm hook of the JAX package's diffrax interop."""

from .state import from_numpy_padded, to_numpy_padded  # noqa: F401
from .diffrax_ext import (  # noqa: F401
    diffeqsolve,
    diffrax_available,
    global_wrms_norm,
)
