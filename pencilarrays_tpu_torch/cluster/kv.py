"""The coordination wire: a small key-value store (the part of the JAX
package's ``cluster/kv.py`` that works without a cluster runtime).

Everything the cluster layer does reduces to *put a small JSON blob
under a key; read the peers' blobs back*.  :class:`FileKV` does that over
a shared directory, each key one atomically published file: N plain
processes on one box, or N threads in one process, can run the mesh
aggregator (``obs/aggregate.py``) and the drills that need a KV without
a process group.  ``get`` is a bounded wait that calls ``on_wait``
between polls; ``set_if`` is a compare-and-set serialized through a lock
file.  Every wire operation consults the ``kv.get`` / ``kv.set`` fault
points, so a drill can run under ``drop`` (lost operations) or
``partition`` (an unreachable store).

:class:`JaxKV` (in the port a ``torch.distributed`` store client),
:class:`FencedKV` and :func:`resolve_kv` wait for the cluster layer
(ROADMAP.md Queue 1 item 7(d)) and raise.
"""

from __future__ import annotations

import os
import re
import time
from typing import Callable, Optional

from ..resilience.fsutil import atomic_write_text, fsync_dir
from .errors import ConsensusTimeoutError

__all__ = ["FileKV", "JaxKV", "FencedKV", "resolve_kv"]

_LATER = "not ported yet: ROADMAP.md Queue 1, item 7(d) (cluster/)"

_SEGMENT_RE = re.compile(r"^[A-Za-z0-9._=-]+$")


def _fire_kv(point: str, key: str, backend: str) -> Optional[str]:
    """The KV wire's fault tap — one consult per wire operation (each
    ``try_get``/blocking-``get`` poll fires ``kv.get``, each
    ``set``/``set_if``/``delete`` fires ``kv.set``).  ``drop`` and
    ``partition`` come back as cooperative mode strings the caller
    honors; the ``armed`` probe keeps the no-faults path at one cheap
    check per op."""
    from ..resilience import faults

    if not faults.armed(point):
        return None
    return faults.fire(point, key=key, backend=backend)


class FileKV:
    """Filesystem-backed KV: one atomically published file per key.

    Keys are ``/``-separated paths of ``[A-Za-z0-9._=-]`` segments,
    mapped to files under ``root``.  Writes use the resilience layer's
    atomic publish (tmp + fsync + ``os.replace`` + parent-directory
    fsync), so a reader never sees a torn value — the same durability
    discipline as every other metadata commit point in the tree.  A
    key's *ancestor directories* are fsync'd in their own parents as
    they are created (see :meth:`_ensure_dir`): without that, a host
    crash after the atomic publish could lose the freshly created
    directory chain and with it the published-looking key.  Each rank
    writes only its own keys (rank-suffixed), so plain ``set`` calls
    never collide; the one multi-writer key (the fence) goes through
    :meth:`set_if`.
    """

    # how long racing CAS writers wait on the per-key lock file before
    # concluding its holder died mid-swap (the lock critical section is
    # a few syscalls — seconds of wait means a crashed holder)
    CAS_LOCK_TIMEOUT_S = 5.0

    def __init__(self, root: str):
        self.root = os.fspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        parts = key.split("/")
        for p in parts:
            if p in (".", "..") or not _SEGMENT_RE.match(p):
                raise ValueError(f"bad KV key segment {p!r} in {key!r}")
        return os.path.join(self.root, *parts)

    def _ensure_dir(self, d: str) -> None:
        """``makedirs`` + fsync of every newly created ancestor's
        parent.  The atomic publish fsyncs the *file's* directory
        entry, but a brand-new directory's own entry in *its* parent
        was never ordered — a crash could unlink the whole chain and
        take the key with it."""
        if not d or os.path.isdir(d):
            return
        missing = []
        cur = d
        while cur and not os.path.isdir(cur):
            missing.append(cur)
            parent = os.path.dirname(cur)
            if parent == cur:
                break
            cur = parent
        os.makedirs(d, exist_ok=True)
        for m in reversed(missing):          # top-down: parents first
            fsync_dir(os.path.dirname(m) or ".")

    def set(self, key: str, value: str) -> None:
        path = self._path(key)
        act = _fire_kv("kv.set", key, "file")
        if act == "partition":
            raise ConsensusTimeoutError(
                f"KV wire partitioned: set of {key!r} unreachable",
                key=key)
        if act == "drop":
            return          # the lost write: acked locally, never stored
        self._ensure_dir(os.path.dirname(path))
        if act == "torn":
            # a torn publish: a value prefix lands NON-atomically (the
            # reader-facing breach the atomic publish exists to prevent),
            # then the process dies — consumers must surface their typed
            # unparseable-payload paths, never garbage semantics
            with open(path, "w") as f:
                f.write(value[: max(1, len(value) // 2)])
                f.flush()
                os.fsync(f.fileno())
            from ..resilience.faults import kill_now

            kill_now()
        atomic_write_text(path, value)

    def set_if(self, key: str, value: str,
               expected: Optional[str]) -> bool:
        """Compare-and-set: publish ``value`` iff the key's current
        value is ``expected`` (``None`` = the key must not exist yet).
        Racing writers serialize through a sibling ``<key>.lock`` file
        (``O_CREAT|O_EXCL`` — atomic on one filesystem), the publish
        itself stays atomic, so exactly one of N concurrent swappers
        wins.  Returns True iff this call's value was published.  A
        lock held past :data:`CAS_LOCK_TIMEOUT_S` (a writer crashed
        inside the critical section) is broken and the swap retried."""
        path = self._path(key)
        act = _fire_kv("kv.set", key, "file")
        if act == "partition":
            raise ConsensusTimeoutError(
                f"KV wire partitioned: set_if of {key!r} unreachable",
                key=key)
        if act == "drop":
            return True     # the lost write: reported swapped, never stored
        self._ensure_dir(os.path.dirname(path))
        lock = path + ".lock"
        deadline = time.monotonic() + self.CAS_LOCK_TIMEOUT_S
        while True:
            try:
                fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.close(fd)
                break
            except FileExistsError:
                if time.monotonic() >= deadline:
                    # the holder died mid-swap: break the lock (the
                    # publish underneath is atomic either way)
                    try:
                        os.unlink(lock)
                    except FileNotFoundError:
                        pass
                    deadline = time.monotonic() + self.CAS_LOCK_TIMEOUT_S
                time.sleep(0.002)
        try:
            try:
                with open(path) as f:
                    current: Optional[str] = f.read()
            except FileNotFoundError:
                current = None
            if current != expected:
                return False
            atomic_write_text(path, value)
            return True
        finally:
            try:
                os.unlink(lock)
            except FileNotFoundError:   # pragma: no cover - lock broken
                pass

    def try_get(self, key: str) -> Optional[str]:
        if _fire_kv("kv.get", key, "file") in ("drop", "partition"):
            return None     # a dropped read misses; a partitioned one
        try:                # cannot see the store at all
            with open(self._path(key)) as f:
                return f.read()
        except FileNotFoundError:
            return None

    def get(self, key: str, timeout: float, *,
            poll: float = 0.05,
            on_wait: Optional[Callable[[], None]] = None) -> str:
        """Blocking read with deadline; ``on_wait()`` runs between polls
        (and may raise — e.g. the peer-lease check).  Under an armed
        ``kv.get:partition`` every poll misses, so the wait runs out
        into the same typed :class:`ConsensusTimeoutError` a real
        partition produces."""
        deadline = time.monotonic() + timeout
        while True:
            v = self.try_get(key)
            if v is not None:
                return v
            if on_wait is not None:
                on_wait()
            if time.monotonic() >= deadline:
                raise ConsensusTimeoutError(
                    f"KV key {key!r} did not appear within {timeout:.1f}s",
                    key=key, timeout_s=timeout)
            time.sleep(min(poll, max(0.0, deadline - time.monotonic())))

    def delete(self, key: str) -> None:
        act = _fire_kv("kv.set", key, "file")
        if act == "partition":
            raise ConsensusTimeoutError(
                f"KV wire partitioned: delete of {key!r} unreachable",
                key=key)
        if act == "drop":
            return
        try:
            os.unlink(self._path(key))
        except FileNotFoundError:
            pass

    def list_dir(self, prefix: str) -> dict:
        """All ``key -> value`` pairs directly under ``prefix`` (one
        level, no recursion) — the discovery primitive the elastic
        layer uses to find pending join requests.  Missing prefix means
        no entries; unreadable entries (a concurrent atomic publish) are
        skipped, never raised."""
        root = self._path(prefix)
        out = {}
        try:
            names = sorted(os.listdir(root))
        except OSError:
            return out
        for name in names:
            if not _SEGMENT_RE.match(name) or name.endswith(
                    (".tmp", ".lock")):
                continue    # in-flight publish / CAS scaffolding
            v = self.try_get(f"{prefix}/{name}")
            if v is not None:
                out[f"{prefix}/{name}"] = v
        return out


class JaxKV:
    """The JAX package's KV over its distributed runtime; in the port a
    ``torch.distributed`` store client.  Not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"cluster.kv.JaxKV is {_LATER}")


class FencedKV:
    """The JAX package's write-fencing KV wrapper.  Not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"cluster.kv.FencedKV is {_LATER}")


def resolve_kv(env_value: str):
    """The JAX package's KV resolution from the cluster gate's value.
    Not ported yet."""
    raise NotImplementedError(f"cluster.kv.resolve_kv() is {_LATER}")
