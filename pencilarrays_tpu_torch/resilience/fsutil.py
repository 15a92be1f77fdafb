"""Durable filesystem primitives shared by the I/O drivers and the
checkpoint manager (a copy of the JAX package's
``resilience/fsutil.py``) — ONE implementation of the atomic fsync'd publish,
so every metadata commit point in the tree carries identical durability
guarantees (tmp write + data fsync + ``os.replace`` + directory fsync).
"""

from __future__ import annotations

import json
import os
import threading

__all__ = ["fsync_dir", "atomic_write_json", "atomic_write_text"]


def fsync_dir(path: str) -> None:
    """Durably order a rename/replace within its directory (best effort:
    not every FS supports directory fsync)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _atomic_publish(path: str, write_body) -> None:
    # the temporary is the writer's own (process and thread): two writers
    # publishing one path at once must not write, and rename away, each
    # other's temporary (the last replace wins)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "w") as f:
        write_body(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(path) or ".")


def atomic_write_json(path: str, obj) -> None:
    """Atomically publish ``obj`` as JSON at ``path``: a crash at any
    point leaves either the previous content or the new one, never a
    torn file."""
    _atomic_publish(path, lambda f: json.dump(obj, f, indent=1))


def atomic_write_text(path: str, text: str) -> None:
    _atomic_publish(path, lambda f: f.write(text))
