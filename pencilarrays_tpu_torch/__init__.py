"""pencilarrays_tpu_torch — pencil-decomposition arrays on PyTorch and CUDA.

The PyTorch port of ``pencilarrays_tpu``, written for NVIDIA Hopper (H100).
One process per device over ``torch.distributed`` (NCCL on the card, gloo
on the CPU), as the Julia reference runs under MPI.  Module names follow
the JAX package, so each piece has an obvious counterpart there.

Quick start (every rank runs the same program)::

    import pencilarrays_tpu_torch as pat

    pat.distributed.initialize()                 # NCCL, 1 rank
    topo = pat.Topology((1, 1))                  # on cuda:<local rank>
    pen = pat.Pencil(topo, (64, 64, 64))
    u = pat.PencilArray.zeros(pen)
    v = pat.transpose(u, pen.replace(decomp_dims=(0, 2)))

Entry points run on the card unless the caller passes ``device="cpu"``;
asking for CUDA where there is none raises.  Importing the package builds
nothing: the CUDA kernel (``ops/csrc/permute.cu``) is compiled at its
first launch.
"""

from .utils.permutations import (  # noqa: F401
    NO_PERMUTATION,
    NoPermutation,
    Permutation,
)
from .utils.permuted_indices import (  # noqa: F401
    PermutedCartesianIndices,
    PermutedLinearIndices,
)
from .parallel import distributed  # noqa: F401
from .parallel.topology import Topology, dims_create  # noqa: F401
from .parallel.pencil import (  # noqa: F401
    IndexOrder,
    LogicalOrder,
    MemoryOrder,
    Pencil,
    local_data_range,
    make_pencil,
)
from .parallel.arrays import PencilArray, global_view  # noqa: F401
from .parallel.gather import gather  # noqa: F401
from .parallel.transpositions import (  # noqa: F401
    AllToAll,
    Alltoallv,
    Auto,
    Gspmd,
    Pipelined,
    PointToPoint,
    Ring,
    Transposition,
    reshard,
    resolve_method,
    transpose,
    transpose_cost,
)
from .parallel.multiarrays import ManyPencilArray  # noqa: F401
from .ops.localgrid import LocalRectilinearGrid, localgrid  # noqa: F401
from .ops.fft import PencilFFTPlan  # noqa: F401
from .utils.timers import (  # noqa: F401
    TimerOutput,
    disable_debug_timings,
    enable_debug_timings,
    timeit,
)
from .compat import (  # noqa: F401
    GlobalPencilArray,
    MPITopology,
    PencilArrayCollection,
    decomposition,
    extra_dims,
    get_comm,
    length_global,
    length_local,
    ndims_extra,
    ndims_space,
    pencil,
    permutation,
    range_local,
    range_remote,
    size_global,
    size_local,
    sizeof_global,
    timer,
    to_local,
    topology,
)
from . import ops  # noqa: F401

__version__ = "0.1.0"
