"""Conversion of state between the JAX package and the port."""

from .state import from_numpy_padded, to_numpy_padded  # noqa: F401
