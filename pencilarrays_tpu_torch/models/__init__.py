"""Models built on the port's FFT plans and pencil transposes."""

from .diffusion import DiffusionSpectral  # noqa: F401
from .spectral import NavierStokesSpectral, taylor_green  # noqa: F401
from .attention import (  # noqa: F401
    dense_attention,
    flash_attention,
    from_zigzag,
    ring_attention,
    to_zigzag,
    ulysses_attention,
    zigzag_indices,
)
