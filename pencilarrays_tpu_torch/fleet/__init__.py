"""Multi-mesh fleet federation — routing, health, failover, scaling (the
JAX package's ``fleet/``, ported).

Everything below this package assumes ONE resident mesh; this layer
federates N of them.  A :class:`~pencilarrays_tpu_torch.fleet.router.
FleetRouter` owns client admission and places requests across N
:class:`~pencilarrays_tpu_torch.serve.PlanService` back-ends over the
existing KV wire, priced through the two-tier intra-mesh/DCN cost model
(:mod:`~pencilarrays_tpu_torch.fleet.cost` — intra-mesh traffic (NVLink) is cheap,
cross-mesh moves pay the data-center network, following AccFFT's
hierarchy framing).  Per-mesh health leases
(:mod:`~pencilarrays_tpu_torch.fleet.health`) turn whole-mesh death into a
typed :class:`~pencilarrays_tpu_torch.fleet.errors.MeshFailureError` in
~ttl seconds, and failover re-binds the dead mesh's tickets to a
sibling — every submitted request still resolves exactly once.  A
router constructed with a ``wal_dir`` write-AHEAD logs every
admission/placement/completion (:mod:`~pencilarrays_tpu_torch.fleet.wal`)
so even a router SIGKILL keeps that contract:
:meth:`~pencilarrays_tpu_torch.fleet.router.FleetRouter.recover` replays
the log and re-parks every unresolved ticket.  The flagged
:class:`~pencilarrays_tpu_torch.fleet.scale.FleetSupervisor` turns the
autoscaler's journaled ``acted=false`` demand signals into
actually-launched workers.  See ``docs/Fleet.md``.

In the port a mesh of P ranks is P processes, each with its own
:class:`~pencilarrays_tpu_torch.serve.PlanService`: the mesh's rank 0
speaks for it on the wire (:class:`~pencilarrays_tpu_torch.fleet.worker.
MeshWorker`), and the KV values are byte for byte the JAX package's, so
a JAX router places on a port mesh and a port router on a JAX mesh.
"""

from __future__ import annotations

import os

from .cost import FleetCost
from .errors import FleetError, MeshFailureError, MeshLeftError
from .health import MeshBoard, MeshLease
from .router import FleetRouter
from .scale import FleetSupervisor
from .wal import RouterWAL
from .worker import MeshWorker

__all__ = [
    "FleetCost", "FleetError", "FleetRouter", "FleetSupervisor",
    "MeshBoard", "MeshFailureError", "MeshLease", "MeshLeftError",
    "MeshWorker", "RouterWAL", "mesh_id", "MESH_ENV",
]

# this process's fleet mesh identity, for the faults layer's %mesh<k>
# selector (a sibling of the cluster layer's rank resolution): worker
# launchers set it; a process that never joined a mesh answers -1 and
# matches no %mesh rule
MESH_ENV = "PENCILARRAYS_TPU_FLEET_MESH"


def mesh_id() -> int:
    """This process's mesh id (``PENCILARRAYS_TPU_FLEET_MESH``, else
    -1 = not a mesh worker)."""
    try:
        return int(os.environ[MESH_ENV])
    except (KeyError, ValueError):
        return -1
