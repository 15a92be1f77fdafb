"""The cluster layer's identity and epoch (the part of the JAX package's
``cluster/`` that the engine and the journal need).

:func:`rank` and :func:`world_size` resolve this process's identity as
the JAX package does: the ``PENCILARRAYS_TPU_CLUSTER_RANK`` /
``_WORLD`` overrides first, then the process group (``torch.distributed``
in place of ``jax.distributed``), else 0 and 1.  :func:`enabled` is the
``PENCILARRAYS_TPU_CLUSTER`` gate and :func:`current_epoch` the recovery
epoch.  :func:`coordinator` keeps the JAX package's contract where it
needs no coordinator: ``None`` (the local recovery ladder) when the
layer is off or the world is one rank.  Coordination itself (consensus,
health leases, elastic reformation, the KV clients but
:class:`~pencilarrays_tpu_torch.cluster.kv.FileKV`) is not ported yet:
:func:`coordinator` raises where the JAX package would build one, and
:func:`enable` and :func:`disable` raise (ROADMAP Queue 1 item 7(d)).
"""

from __future__ import annotations

from .errors import (  # noqa: F401
    ClusterAbortError,
    ClusterError,
    ConsensusTimeoutError,
    FencedWriteError,
    PeerFailureError,
    PeerLeftError,
    QuorumLossError,
    ReformError,
)

__all__ = [
    "ENV_VAR",
    "RANK_VAR",
    "WORLD_VAR",
    "ClusterError",
    "PeerFailureError",
    "PeerLeftError",
    "ClusterAbortError",
    "ConsensusTimeoutError",
    "ReformError",
    "QuorumLossError",
    "FencedWriteError",
    "enabled",
    "rank",
    "world_size",
    "current_epoch",
    "coordinator",
    "enable",
    "disable",
]

ENV_VAR = "PENCILARRAYS_TPU_CLUSTER"
RANK_VAR = "PENCILARRAYS_TPU_CLUSTER_RANK"
WORLD_VAR = "PENCILARRAYS_TPU_CLUSTER_WORLD"

_LATER = "not ported yet: ROADMAP.md Queue 1, item 7(d) (cluster/)"


def enabled() -> bool:
    """The ``PENCILARRAYS_TPU_CLUSTER`` gate (one cached snapshot probe;
    off tokens match case-insensitively)."""
    from ..engine import config as _rtc

    return _rtc.current().cluster_on


def _dist_identity():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def rank() -> int:
    """This process's rank: the ``PENCILARRAYS_TPU_CLUSTER_RANK``
    override, else the default process group's rank, else 0.  Journal
    attribution reads it."""
    from ..engine import config as _rtc

    r = _rtc.current().cluster_rank
    if r is not None:
        return r
    return _dist_identity()[0]


def world_size() -> int:
    """The number of ranks, under the same resolution order as
    :func:`rank`."""
    from ..engine import config as _rtc

    w = _rtc.current().cluster_world
    if w is not None:
        return w
    return _dist_identity()[1]


def current_epoch() -> int:
    """The recovery epoch (see :mod:`~pencilarrays_tpu_torch.cluster.
    epoch`)."""
    from . import epoch as _epoch

    return _epoch.current()


def coordinator():
    """The process's coordinator, or ``None`` when the layer is off *or*
    the world is a single rank (the degrade-to-local contract of the
    JAX package, one cached probe on the disabled path).  Where the JAX
    package would build a coordinator (the layer on, more than one
    rank) it raises: coordination is not ported yet."""
    if not enabled() or world_size() <= 1:
        return None
    raise NotImplementedError(f"cluster.coordinator() is {_LATER}")


def enable(coordinator_obj) -> None:
    raise NotImplementedError(f"cluster.enable() is {_LATER}")


def disable() -> None:
    raise NotImplementedError(f"cluster.disable() is {_LATER}")


def _reset_for_tests() -> None:
    from . import epoch as _epoch

    _epoch._reset_for_tests()
