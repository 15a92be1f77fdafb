"""The command line and the rank launch that every example shares.

Each example is a ``run(device=None, **sizes) -> dict`` that every rank
calls alike (SPMD), and a ``main(argv=None)`` made by :func:`main`::

    python -m pencilarrays_tpu_torch.examples.<name> \\
        [--device cuda|cpu] [--ranks N] [--<size> VALUE ...]

``--device`` defaults to the card of each rank.  ``--ranks N`` spawns N
processes in one process group: over NCCL when the machine has N cards,
over gloo only when ``--device cpu`` is named; any other case raises.
Nothing falls back to the CPU by itself.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import shutil
import tempfile
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

import numpy as np
import torch.distributed as dist

from ..parallel.distributed import backend_for, is_root

__all__ = ["backend_for", "launch", "main", "is_root", "scalars", "gathered",
           "shared_tmpdir"]


def _rank_run(module: str, device, sizes: Dict[str, Any]):
    return importlib.import_module(module).run(device=device, **sizes)


def launch(module: str, device=None, ranks: int = 1, **sizes) -> List[Any]:
    """``run(device, **sizes)`` of the example ``module`` on ``ranks``
    ranks: in this process for one rank, else on spawned ranks of one
    fresh process group.  Every rank's result, in rank order."""
    backend = backend_for(device, ranks)
    if ranks == 1:
        return [_rank_run(module, device, sizes)]
    from ..parallel.distributed import spawn

    return spawn(_rank_run, ranks, module, device, sizes, backend=backend,
                 timeout_s=3600.0)


def scalars(result: Dict[str, Any]) -> Dict[str, Any]:
    """The printable entries of a result: numbers, strings, flags, and
    short lists and flat dicts of them (arrays are left out)."""
    out = {}
    for k, v in result.items():
        if isinstance(v, (bool, int, float, str)) or v is None:
            out[k] = v
        elif isinstance(v, (list, tuple)) and len(v) <= 64 and all(
                isinstance(x, (bool, int, float, str)) for x in v):
            out[k] = list(v)
        elif isinstance(v, np.generic):
            out[k] = v.item()
        elif isinstance(v, dict) and all(
                isinstance(x, (bool, int, float, str)) for x in v.values()):
            out[k] = v
    return out


def _sized(default):
    if isinstance(default, tuple):
        return lambda s: tuple(int(x) for x in s.split(","))
    return type(default)


def main(module: str, doc: str, sizes: Dict[str, Any],
         argv: Optional[List[str]] = None) -> int:
    """Parse ``--device``, ``--ranks`` and one option per entry of
    ``sizes`` (a tuple as ``a,b,c``), run the example and print rank 0's
    result, one ``name: value`` line per printable entry."""
    p = argparse.ArgumentParser(prog=f"python -m {module}",
                                description=doc.strip().split("\n\n")[0])
    p.add_argument("--device", default=None,
                   help="cuda (default: each rank's card) or cpu")
    p.add_argument("--ranks", type=int, default=1,
                   help="ranks in one process group (NCCL: one per card; "
                        "gloo with --device cpu)")
    for name, default in sizes.items():
        p.add_argument("--" + name.replace("_", "-"), dest=name,
                       type=_sized(default), default=default,
                       help=f"default {default}")
    args = p.parse_args(argv)
    out = launch(module, args.device, args.ranks,
                 **{k: getattr(args, k) for k in sizes})
    for k, v in scalars(out[0]).items():
        print(f"{k}: {json.dumps(v)}")
    return 0


# fields of at most this many elements come back gathered in a result
GATHER_MAX = 1 << 21


def gathered(x):
    """The gathered global array of ``x`` on rank 0 when it is small
    (at most :data:`GATHER_MAX` elements), else None.  Every rank must
    call it."""
    from .. import gather

    if math.prod(x.pencil.size_global()) * math.prod(x.extra_dims) \
            > GATHER_MAX:
        return None
    return gather(x)


@contextmanager
def shared_tmpdir(prefix: str):
    """One temporary directory for every rank (rank 0 makes it and
    sends its path), removed after the block on every rank's exit."""
    path = [tempfile.mkdtemp(prefix=prefix) if is_root() else None]
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.broadcast_object_list(path, src=0)
    try:
        yield path[0]
    finally:
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.barrier()
        if is_root():
            shutil.rmtree(path[0], ignore_errors=True)
