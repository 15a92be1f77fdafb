"""Streaming block checksums for checkpoint manifests (a copy of the JAX
package's ``resilience/checksum.py``: the same backends in the same
order, so both packages record and verify the same ``algo``).

CRC32C (Castagnoli — the checksum of GCS, TensorStore and most storage
stacks) via ``google-crc32c`` or ``crc32c`` when available, falling back
to ``zlib.crc32``; the algorithm actually used travels in the manifest
(``"algo"``), so a checkpoint written with one is verified with the
same one.

Checksums are computed over each per-shard block's **logical-order
bytes** during the same ``iter_local_blocks`` streaming the drivers
write from — the block is already the write's staged host copy, and the CRC walks it in
bounded chunks, so checksumming adds no extra host copy of the array
(at most one transient ``_CHUNK``-sized buffer for the C bindings,
which require ``bytes``).
"""

from __future__ import annotations

import zlib
from typing import Callable, Dict, List

import numpy as np

__all__ = ["ALGO", "supported", "crc_update", "crc_of_array",
           "BlockChecksums"]

_CHUNK = 1 << 24  # 16 MiB: bounds the transient bytes copy per update


def _zlib_extend(crc: int, data: bytes) -> int:
    return zlib.crc32(data, crc)


# every backend this host can compute, keyed by the manifest algo name —
# a verifier uses the WRITER's algorithm, not its own default
_BACKENDS: Dict[str, Callable[[int, bytes], int]] = {"crc32": _zlib_extend}
try:
    import google_crc32c

    _BACKENDS["crc32c"] = google_crc32c.extend
except ImportError:
    try:
        import crc32c as _c

        _BACKENDS["crc32c"] = lambda crc, data: _c.crc32c(data, crc)
    except ImportError:
        pass

ALGO = "crc32c" if "crc32c" in _BACKENDS else "crc32"


def supported(algo: str) -> bool:
    return algo in _BACKENDS


def crc_update(crc: int, data: bytes, algo: str = ALGO) -> int:
    return _BACKENDS[algo](crc, data) & 0xFFFFFFFF


def crc_of_array(a: np.ndarray, algo: str = ALGO) -> int:
    """CRC of an array's C-order bytes, streamed in bounded chunks."""
    a = np.ascontiguousarray(a)
    flat = a.reshape(-1).view(np.uint8)
    crc = 0
    for i in range(0, flat.size, _CHUNK):
        crc = crc_update(crc, flat[i:i + _CHUNK].tobytes(), algo)
    return crc


class BlockChecksums:
    """Per-dataset block CRC accumulator fed by the drivers'
    ``block_observer`` hook: one entry per streamed block, keyed by its
    logical-order global corner (decomposition-independent — a verifier
    under ANY process layout can re-read exactly these ranges)."""

    def __init__(self):
        self._datasets: Dict[str, List[dict]] = {}

    def observer(self, dataset: str) -> Callable:
        blocks = self._datasets.setdefault(dataset, [])

        def observe(start, block):
            blocks.append({
                "start": [int(s) for s in start],
                "shape": [int(s) for s in block.shape],
                "crc": crc_of_array(block),
            })

        return observe

    def blocks(self, dataset: str) -> List[dict]:
        return sorted(self._datasets.get(dataset, []),
                      key=lambda b: tuple(b["start"]))

    def as_dict(self) -> Dict[str, List[dict]]:
        return {name: self.blocks(name) for name in sorted(self._datasets)}
