"""Models built on the port's FFT plans, pencil transposes and stencils."""

from .diffusion import DiffusionSpectral  # noqa: F401
from .heat_fd import HeatFD  # noqa: F401
from .ode import integrate, rk23_step  # noqa: F401
from . import ode  # noqa: F401
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
