"""The one place the port constructs threads (the JAX package's
``engine/threads.py``).

Every long-lived thread of the package (the engine's dispatch consumer
and host workers) is born here, through :func:`spawn_thread`, so every
runtime thread carries a ``pa-`` prefixed name a stack dump attributes
to its subsystem, and :func:`spawned` lists what this process started.
Threads are daemonic: shutdown is owned by explicit ``close`` calls,
never by a join at exit.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

__all__ = ["spawn_thread", "spawned"]

_lock = threading.Lock()
_spawned: List[str] = []        # names, most recent last (bounded)
_MAX_NAMES = 512


def spawn_thread(target: Callable, *, name: str, daemon: bool = True,
                 args: tuple = (), kwargs: Optional[dict] = None
                 ) -> threading.Thread:
    """Construct AND start one named runtime thread (``name`` is required
    and should carry the ``pa-`` subsystem prefix).  Returns the started
    thread."""
    t = threading.Thread(target=target, name=name, daemon=daemon,
                         args=args, kwargs=kwargs or {})
    with _lock:
        _spawned.append(name)
        if len(_spawned) > _MAX_NAMES:
            del _spawned[: _MAX_NAMES // 2]
    t.start()
    return t


def spawned() -> List[str]:
    """Names of every thread this process has spawned through the choke
    point (bounded history, most recent last)."""
    with _lock:
        return list(_spawned)
