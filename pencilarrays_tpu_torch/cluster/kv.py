"""The coordination wire: a small key-value store with two backends (the
JAX package's ``cluster/kv.py``).

Everything the cluster layer does reduces to *put a small JSON blob under
a key; read the peers' blobs back*.  Two interchangeable backends provide
that:

* :class:`StoreKV` (alias :class:`JaxKV`, the JAX package's name) — a
  client over a ``torch.distributed`` store (``TCPStore``, ``FileStore``,
  the default group's store): the rendezvous service every job already
  runs, in place of the JAX distributed runtime's KV store;
* :class:`FileKV` — a shared directory, each key one atomically published
  file: N plain processes on one box, or N threads in one process, run
  the full consensus and lease machinery without a process group.

Both expose the same operations, and the keys, values and fence records
are the JAX package's, so one KV directory serves both packages.  ``get``
is a bounded wait that calls ``on_wait`` between polls (the lease check,
so a wait on a dead peer's key becomes a typed
:class:`~pencilarrays_tpu_torch.cluster.errors.PeerFailureError`);
``set_if`` is a compare-and-set, serialized through a lock file on
:class:`FileKV` and a read-verify-``compare_set`` on :class:`StoreKV`;
:class:`FencedKV` rejects the writes of a rank whose ``(generation,
epoch)`` token is behind the namespace's published fence.  Every wire
operation consults the ``kv.get`` / ``kv.set`` fault points, so a drill
can run under ``drop`` (lost operations) or ``partition`` (an unreachable
store).
"""

from __future__ import annotations

import json
import os
import re
import time
from datetime import timedelta
from typing import Callable, Optional, Tuple

from ..resilience.fsutil import atomic_write_text, fsync_dir
from .errors import ConsensusTimeoutError, FencedWriteError

__all__ = ["FileKV", "StoreKV", "JaxKV", "FencedKV", "resolve_kv"]

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


class StoreKV:
    """A ``torch.distributed`` store as the KV wire (the JAX package's
    ``JaxKV`` over its distributed runtime's store).

    ``store`` is any ``torch.distributed.Store``; the client works on its
    own clone where the store can be cloned, with a blocking-read timeout
    of :data:`SLICE_S`, so the process group's client keeps its own.
    Blocking gets are sliced into short waits so ``on_wait`` (the lease
    check) still runs while a peer's key is pending.  A store has no
    conditional write that tells create from swap, so :meth:`set_if`
    reads, verifies and then ``compare_set``s: atomic against a racing
    swap of the same expected value, best-effort across a delete, as the
    JAX package's ``set_if`` is documented to be."""

    SLICE_S = 1.0

    def __init__(self, store):
        try:
            client = store.clone()
            client.set_timeout(timedelta(seconds=self.SLICE_S))
        except Exception:   # a store without clone(): share its client
            client = store
        self._store = client

    @classmethod
    def from_initialized(cls) -> "StoreKV":
        from ..parallel.distributed import kv_client

        store = kv_client()
        if store is None:
            raise RuntimeError(
                "no torch.distributed store: call "
                "pencilarrays_tpu_torch.distributed.initialize() first (or "
                "point PENCILARRAYS_TPU_CLUSTER at a shared directory to use "
                "the filesystem backend)")
        return cls(store)

    def set(self, key: str, value: str) -> None:
        act = _fire_kv("kv.set", key, "store")
        if act == "partition":
            raise ConsensusTimeoutError(
                f"KV wire partitioned: set of {key!r} unreachable",
                key=key)
        if act == "drop":
            return
        self._store.set(key, value)

    def set_if(self, key: str, value: str,
               expected: Optional[str]) -> bool:
        """Compare-and-set with :class:`FileKV`'s outcomes: ``expected``
        None creates (the key must not exist), else swaps; True iff this
        call's value was published."""
        act = _fire_kv("kv.set", key, "store")
        if act == "partition":
            raise ConsensusTimeoutError(
                f"KV wire partitioned: set_if of {key!r} unreachable",
                key=key)
        if act == "drop":
            return True
        if self._raw_try_get(key) != expected:
            return False
        stored = self._store.compare_set(
            key, "" if expected is None else expected, value)
        return _text(stored) == value

    def _raw_try_get(self, key: str) -> Optional[str]:
        try:
            if not self._store.check([key]):
                return None
            return _text(self._store.get(key))
        except Exception:   # deleted between check and get, or weather
            return None

    def try_get(self, key: str) -> Optional[str]:
        if _fire_kv("kv.get", key, "store") in ("drop", "partition"):
            return None
        return self._raw_try_get(key)

    def get(self, key: str, timeout: float, *,
            poll: float = 0.05,
            on_wait: Optional[Callable[[], None]] = None) -> str:
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise ConsensusTimeoutError(
                    f"KV key {key!r} did not appear within {timeout:.1f}s",
                    key=key, timeout_s=timeout)
            slice_s = min(self.SLICE_S, remaining)
            t0 = time.monotonic()
            if _fire_kv("kv.get", key, "store") in ("drop", "partition"):
                # the wire is down for this slice: pace like a missed
                # read so the deadline (and the lease check) still runs
                if on_wait is not None:
                    on_wait()
                time.sleep(min(poll, max(0.0,
                                         deadline - time.monotonic())))
                continue
            try:
                self._store.wait([key], timedelta(seconds=slice_s))
                return _text(self._store.get(key))
            except Exception:
                if on_wait is not None:
                    on_wait()
                # a not-found wait consumes the whole slice; anything that
                # failed faster is store weather: pace the loop so a dead
                # store cannot hot-spin the verdict timeout away
                if time.monotonic() - t0 < slice_s / 2:
                    time.sleep(min(poll, max(0.0,
                                             deadline - time.monotonic())))

    def delete(self, key: str) -> None:
        act = _fire_kv("kv.set", key, "store")
        if act == "partition":
            raise ConsensusTimeoutError(
                f"KV wire partitioned: delete of {key!r} unreachable",
                key=key)
        if act == "drop":
            return
        try:
            self._store.delete_key(key)
        except Exception:
            pass

    def list_dir(self, prefix: str) -> dict:
        """The store's keys directly under ``prefix`` (one level), as
        :class:`FileKV` lists them: a store's own keys (a ``FileStore``'s
        ``efcount/``) and in-flight scaffolding are left out, and a store
        without ``list_keys`` (an older torch) lists nothing — join
        discovery then finds nobody, it never crashes a reformation."""
        list_keys = getattr(self._store, "list_keys", None)
        if list_keys is None:
            return {}
        try:
            keys = list_keys()
        except Exception:
            return {}
        head = f"{prefix}/"
        out = {}
        for key in sorted(_text(k) for k in keys):
            name = key[len(head):]
            if (not key.startswith(head) or "/" in name
                    or not _SEGMENT_RE.match(name)
                    or name.endswith((".tmp", ".lock"))):
                continue
            v = self._raw_try_get(key)
            if v is not None:
                out[key] = v
        return out


#: the JAX package's name of the runtime-store backend
JaxKV = StoreKV


def _text(v) -> str:
    return v.decode() if isinstance(v, (bytes, bytearray)) else str(v)


class FencedKV:
    """Write-fencing wrapper over either backend — the zombie guard.

    The live mesh publishes a **fence** — the JSON pair
    ``{"gen": G, "epoch": E}`` under ``<namespace>/fence`` in the *base*
    namespace (so it spans generation-suffixed sub-namespaces) — advanced
    by the agreed new generation's rank 0 at every reformation
    (:meth:`advance`, CAS-guarded, monotonic).  Every write through this
    wrapper compares its own ``(generation, epoch)`` token against the
    published fence first: a token strictly behind the fence is a
    **zombie** — a rank that was evicted, slept through the reformation,
    and woke up still believing it is a member — and its write is
    rejected with typed :class:`FencedWriteError` *before* touching the
    store, journaled fsync-critically (``cluster.fence``) and counted
    (``cluster.fenced_writes``).

    Check-then-write is not atomic: a write racing the fence advance
    itself can slip through for one advance window, harmless by
    construction (the racing writer was a member until this very advance,
    so its value is at worst one reformation stale).  What the fence kills
    is the unbounded case — arbitrarily late zombie writes into a
    namespace that reformed generations ago.  Reads pass through
    unchecked."""

    FENCE_SEGMENT = "fence"

    def __init__(self, kv, *, namespace: str = "pa",
                 generation: int = 0, epoch: int = 0):
        self.kv = kv
        self.ns = namespace
        self.generation = int(generation)
        self.epoch = int(epoch)

    # -- the fence itself ---------------------------------------------------
    @property
    def fence_key(self) -> str:
        return f"{self.ns}/{self.FENCE_SEGMENT}"

    def token(self) -> Tuple[int, int]:
        """This writer's fencing token — compared lexicographically
        (generation outranks epoch)."""
        return (self.generation, self.epoch)

    def fence(self) -> Optional[Tuple[int, int]]:
        """The published fence, or ``None`` (nobody has fenced this
        namespace yet — every token passes)."""
        return _parse_fence(self.kv.try_get(self.fence_key))

    def advance(self, generation: int, epoch: int) -> Tuple[int, int]:
        """Publish a new fence — monotonic and CAS-guarded: concurrent
        advances serialize on the swap, and the fence never moves
        backwards (an advance that lost the race to a *higher* fence
        adopts it instead of regressing it).  The caller's own token is
        updated to the published fence.  Returns the fence now in
        force."""
        new = (int(generation), int(epoch))
        for _ in range(64):
            raw = self.kv.try_get(self.fence_key)
            cur = _parse_fence(raw)
            if cur is not None and cur >= new:
                self.generation, self.epoch = cur
                return cur
            value = json.dumps({"gen": new[0], "epoch": new[1]})
            # kv-unfenced: this CAS is the fence-advance itself
            if self.kv.set_if(self.fence_key, value, raw):
                self.generation, self.epoch = new
                return new
        raise ConsensusTimeoutError(          # pragma: no cover - needs a
            f"fence advance at {self.fence_key!r} lost 64 straight CAS "
            f"races", key=self.fence_key)     # pathological writer storm

    def _check(self, key: str) -> None:
        fence = self.fence()
        if fence is None or self.token() >= fence:
            return
        from .. import obs

        if obs.enabled():
            obs.counter("cluster.fenced_writes").inc()
            obs.record_event("cluster.fence", key=key,
                             gen=self.generation, epoch=self.epoch,
                             fence_gen=fence[0], fence_epoch=fence[1])
        raise FencedWriteError(
            f"fenced write to {key!r} rejected: token "
            f"(gen={self.generation}, epoch={self.epoch}) is behind the "
            f"published fence (gen={fence[0]}, epoch={fence[1]}) — this "
            f"process was evicted and must stop, not retry",
            key=key, token=self.token(), fence=fence)

    # -- the KV surface (writes checked, reads passed through) ---------------
    def set(self, key: str, value: str) -> None:
        self._check(key)
        self.kv.set(key, value)        # kv-unfenced: the check above IS the fence

    def set_if(self, key: str, value: str,
               expected: Optional[str]) -> bool:
        self._check(key)
        return self.kv.set_if(key, value, expected)  # kv-unfenced: checked above

    def delete(self, key: str) -> None:
        self._check(key)
        self.kv.delete(key)            # kv-unfenced: the check above IS the fence

    def try_get(self, key: str) -> Optional[str]:
        return self.kv.try_get(key)

    def get(self, key: str, timeout: float, **kwargs) -> str:
        return self.kv.get(key, timeout, **kwargs)

    def list_dir(self, prefix: str) -> dict:
        return self.kv.list_dir(prefix)


def _parse_fence(raw: Optional[str]) -> Optional[Tuple[int, int]]:
    """An unparseable fence reads as no fence (fail-open for readers; the
    advance CAS still serializes on the raw value, so wreckage cannot
    wedge the namespace)."""
    if raw is None:
        return None
    try:
        blob = json.loads(raw)
        return (int(blob["gen"]), int(blob["epoch"]))
    except (ValueError, KeyError, TypeError):
        return None


def resolve_kv(env_value: str):
    """Backend from the gate value: ``1``/``on``/``true`` = the default
    process group's store (:class:`StoreKV`); any other (non-off) value is
    a shared directory for :class:`FileKV`.  On/off tokens match
    case-insensitively (``True``/``ON`` must not silently become a
    relative FileKV directory literally named ``True``)."""
    if env_value.strip().lower() in ("1", "on", "true"):
        return StoreKV.from_initialized()
    return FileKV(env_value)
