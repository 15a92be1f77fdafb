"""Models built on the port's FFT plans."""

from .diffusion import DiffusionSpectral  # noqa: F401
from .spectral import NavierStokesSpectral, taylor_green  # noqa: F401
