"""Front-end router process for the port's WAL drill (the JAX package's
``tests/router_worker.py``, ported).

One OS process = the fleet FRONT-END: a
:class:`~pencilarrays_tpu_torch.fleet.FleetRouter` with a durable WAL
over the shared ``FileKV`` wire, submitting a deterministic storm of
seeded requests against the meshes of ``torch_fleet_worker.py``.  The
launcher arms ``fleet.route:kill@<n>`` in THIS process's environment, so
the router SIGKILLs itself at its n-th admission.  The parent then
replays the WAL into a fresh router and proves every committed admission
resolves exactly once.  It touches no device.

Payloads are derived from the request index (``default_rng(1000+i)``),
shaped like the named plan ``name`` (the JAX worker's c2c ``(8, 6, 4)``
minnow by default, or a real float32 cube of edge ``n``), so the parent
can regenerate any of them without a side channel.

Usage::

    python torch_router_worker.py <kvroot> <waldir> <nreq> <meshes-csv>
        [name n]
"""

import os
import sys


def main():
    kvroot, waldir, nreq, meshes = (
        sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4])
    name = sys.argv[5] if len(sys.argv) > 5 else "minnow"
    n = int(sys.argv[6]) if len(sys.argv) > 6 else None
    ttl = float(os.environ.get("PA_FLEET_TEST_TTL", "2.0"))
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import numpy as np

    from pencilarrays_tpu_torch.cluster.kv import FileKV
    from pencilarrays_tpu_torch.fleet import FleetRouter

    router = FleetRouter(FileKV(kvroot), ttl=ttl, wal_dir=waldir)
    for m in meshes.split(","):
        router.register_mesh(int(m))
    print(f"ROUTER_READY pid={os.getpid()}", flush=True)
    for i in range(nreq):
        rng = np.random.default_rng(1000 + i)
        if n is None:
            u = (rng.standard_normal((8, 6, 4))
                 + 1j * rng.standard_normal((8, 6, 4))).astype(np.complex64)
        else:
            u = rng.standard_normal((n, n, n)).astype(np.float32)
        router.submit("acme", u, name=name)   # armed kill fires here
        router.pump()
    left = router.drain(120.0)
    print(f"ROUTER_DRAINED left={left} "
          f"completed={router.stats()['completed']}", flush=True)
    router.close()


if __name__ == "__main__":
    main()
