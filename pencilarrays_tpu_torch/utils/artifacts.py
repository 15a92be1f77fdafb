"""Measured-verdict artifact loading (a copy of the JAX package's
``utils/artifacts.py``).

Hand-written fast paths in this tree (the Pallas permute, the flash
kernels, the pipelined FFT hops) must justify their default routing with
a NUMBER measured on the real chip, persisted as a JSON artifact at the
repo root (``PALLAS_FLASH_SWEEP.json``, ``PIPELINE_SWEEP.json``, ...).
This module is the one loader for those artifacts:

* default location: the repo root (three dirnames above this package) —
  a source-checkout convention;
* an env-var override points anywhere (installed/site-packages layouts,
  experiment directories);
* results are cached per resolved path and invalidated by file mtime, so
  a sweep that writes the artifact MID-process is picked up without a
  restart (an ``lru_cache`` would pin a first ``None`` forever).
"""

from __future__ import annotations

import json
import os
from typing import Optional

__all__ = ["load_verdict_artifact", "repo_root"]

_CACHE: dict = {}  # resolved path -> (mtime, parsed doc | None)


def repo_root() -> str:
    """Source-checkout repo root (three levels above this file)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def load_verdict_artifact(filename: str, env_var: str = None
                          ) -> Optional[dict]:
    """Parsed JSON artifact ``filename`` (repo root, or the ``env_var``
    override path), or ``None`` when absent/unreadable.  Cached per
    path, invalidated when the file's mtime changes."""
    path = None
    if env_var:
        path = os.environ.get(env_var) or None
    if path is None:
        path = os.path.join(repo_root(), filename)
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        _CACHE.pop(path, None)
        return None
    hit = _CACHE.get(path)
    if hit is not None and hit[0] == mtime:
        return hit[1]
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        doc = None
    _CACHE[path] = (mtime, doc)
    return doc
