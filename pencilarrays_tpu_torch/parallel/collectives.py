"""The one recording hook of the port's collective calls.

The JAX package reads a program's collectives from its compiled HLO
(``analysis/spmd.py`` ``trace_hlo``).  The port has no compiled program
to read, so its choke points report each collective they issue here, as
they issue it: the exchange of a hop (``_Exchange``'s ``all_to_all``
and ring rounds, the Gspmd exchange), ``ring_shift``, the stencil
shifts' halo sends, the reductions' ``all_reduce`` and ``all_gather``
and the guard's probes.  Nothing is
recorded unless a :func:`recording` block is open on the calling
thread: :mod:`~pencilarrays_tpu_torch.analysis.spmd` opens one to trace
a program, an engine dispatch of a plan (``forward_async``, a served
batch) one to count the collectives it issued (``meta["collectives"]``,
what ``verify_dispatch_log`` checks), and a capture of a CUDA graph one
to keep what its replays issue (:func:`replayed`).  Blocks nest: every
open block of the thread records.

Each record is one collective *application* with the fields of the JAX
package's ``CollectiveOp``: its kind under the HLO op names (a ring
round of ``batch_isend_irecv`` is a ``collective-permute``), its bytes
per rank (what ``utils/hlo.py`` ``collective_stats`` prices: the
all-to-all's operand, a ring round's tile, the reduced buffer), the
shape it moved, the ranks of its group (a ring round: the ``(source,
target)`` pair this rank sends along) and whether it was issued
asynchronously.  Calls that cross no rank (a group of one) are not
collectives and are not recorded.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional, Sequence

__all__ = ["recording", "note", "replayed", "stats", "EXCHANGE_KINDS"]

# The data-movement collectives a transpose schedule owns (what
# ``transpose_cost`` prices).  Guard probes and reductions add
# ``all-reduce`` ops beside them.
EXCHANGE_KINDS = ("all-to-all", "collective-permute", "all-gather",
                  "reduce-scatter")

_local = threading.local()


@contextmanager
def recording(watch=None):
    """Record, into the dict it yields, every collective this thread
    issues inside the block: ``{"ops": [record, ...], "released": ...}``.
    ``watch`` (a ``weakref.ref`` to a tensor) is checked at the first
    collective: ``released`` is whether the tensor was already freed
    then, or its storage is the buffer that collective sends (the
    operand became the wire buffer in place); None while no collective
    ran."""
    rec = {"ops": [], "watch": watch, "released": None}
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    stack.append(rec)
    try:
        yield rec
    finally:
        stack.remove(rec)


def _shape_text(shape: Sequence[int], dtype) -> str:
    name = str(dtype).replace("torch.", "") if dtype is not None else "u8"
    return f"{name}[{','.join(str(int(n)) for n in shape)}]"


def note(kind: str, nbytes: int, *, group=None, shape: Sequence[int] = (),
         dtype=None, async_start: bool = False,
         pair: Optional[Sequence[int]] = None, buffer=None) -> None:
    """Report one collective application (a no-op unless a
    :func:`recording` block is open on this thread); ``buffer`` is the
    tensor it sends, where one is sent."""
    stack = getattr(_local, "stack", None)
    if not stack:
        return
    for rec in stack:
        if rec["watch"] is not None and rec["released"] is None:
            held = rec["watch"]()
            rec["released"] = held is None or (
                buffer is not None and held.untyped_storage().data_ptr()
                == buffer.untyped_storage().data_ptr())
            del held
    if pair is not None:
        groups = "{{" + ",".join(str(int(r)) for r in pair) + "}}"
    elif group is not None:
        import torch.distributed as dist

        groups = "{{" + ",".join(
            str(r) for r in dist.get_process_group_ranks(group)) + "}}"
    else:
        groups = None
    op = {"kind": kind, "bytes": int(nbytes),
          "shape": _shape_text(shape, dtype), "replica_groups": groups,
          "async_start": bool(async_start)}
    for rec in stack:
        rec["ops"].append(op)


def replayed(ops) -> None:
    """Report the collectives a CUDA graph replay issued (the records
    taken while it was captured): a replay issues them without a Python
    call."""
    for rec in getattr(_local, "stack", None) or ():
        rec["ops"].extend(ops)


def stats(ops, kinds=None) -> dict:
    """``{op: {"count", "bytes"}}`` of records (of ``kinds`` only, when
    given): the schema of ``transpose_cost`` and ``collective_costs``."""
    out: dict = {}
    for o in ops:
        if kinds is not None and o["kind"] not in kinds:
            continue
        e = out.setdefault(o["kind"], {"count": 0, "bytes": 0})
        e["count"] += 1
        e["bytes"] += o["bytes"]
    return out
