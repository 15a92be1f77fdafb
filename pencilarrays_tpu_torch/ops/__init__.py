"""Local operations of the port: the permute kernel (K1), FFT plans,
reductions, grids, random fills, stencils and spectral operators.

The reductions, stencils and spectral operators are also reachable here
by name (``ops.sum``, ``ops.shift``, ``ops.gradient``), as in the JAX
package."""

from .reductions import (  # noqa: F401
    all,
    any,
    count_nonzero,
    dot,
    extrema,
    mapreduce,
    maximum,
    mean,
    minimum,
    norm,
    prod,
    sum,
)
from .random import normal, uniform  # noqa: F401
from .stencil import (  # noqa: F401
    diff,
    fd_divergence,
    fd_gradient,
    fd_laplacian,
    shift,
)
from .spectral_ops import (  # noqa: F401
    curl,
    divergence,
    gradient,
    laplacian,
    solve_poisson,
)
