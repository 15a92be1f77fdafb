"""Exchange invariant probes: silent-corruption detection for pure data
movement (the JAX package's ``guard/integrity.py``).

Transposes, reshard routes and checkpoint restores move bits and never
change them, so a content sum, an absolute-value sum (the tolerance's
scale) and, on sampled dispatches, a nonfinite count taken over the
operand before and after the hop must agree.  The JAX package computes
them inside the hop's jitted program; the port computes them as
reductions on the card around the hop (before K1's pack, after K1's
unpack), sums the pair over the topology's ranks in one ``all_reduce``
(each rank holds a block, the JAX package's probe covers the global
array), and compares them on the host after one fetch:

* exact dtypes (ints, bool): wrapping integer sums are order
  independent, so the pair must match bit for bit.  Sums of elements of
  at most 32 bits wrap as the JAX package's int32 sum does (its default
  configuration, 64-bit types off); int64 sums wrap in 64 bits;
* inexact dtypes: the hop reorders the reduction, so the sums may differ
  by rounding: the tolerance is ``rtol * (abs_sum + 1)`` with
  ``rtol = eps * (8 + 4 * log2(count))`` (override:
  ``PENCILARRAYS_TPU_GUARD_RTOL``).  A NaN or infinity born inside the
  hop poisons the sum after it and fails, while NaNs already in the
  input match on both sides and pass;
* the sampled finiteness tap also compares the nonfinite counts.

The accumulator follows the data: float64 for f64 and c128 data, float32
for every other inexact dtype.  That is the JAX package's accumulator for
the data each of its configurations can hold (float32 with 64-bit types
off, where f64 data does not exist; float64 with them on).  The sums use
reductions that allocate no full-size temporary (``sum`` and a 1-norm on
real views); nonfinite counts run chunked, on sampled dispatches only.

A mismatch journals ``guard.sdc``, writes a crash bundle and raises
:class:`~pencilarrays_tpu_torch.guard.errors.IntegrityError`.  The
deterministic drill :func:`corrupt_block` is the counter-addressed poke
the ``corrupt`` fault mode applies to a hop's output (``hop.exchange``)
or a restored dataset (``ckpt.restore``): element ``idx % size`` of the
flat padded global array, as in the JAX package, on whichever rank holds
it (:func:`corrupt_array`).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .errors import IntegrityError, WirePrecisionError

__all__ = [
    "acc_dtype",
    "probe_stats",
    "reduce_probes",
    "probes_match",
    "check_hop_probes",
    "corrupt_block",
    "corrupt_array",
    "corrupt_eager",
    "nonfinite_count",
    "report_nonfinite_birth",
    "check_finite_boundary",
]

# elements per chunk of the nonfinite count and the exact-dtype sums:
# their temporaries (a bool mask, an int64 copy) stay at most this big
_CHUNK = 1 << 24


def _exact(dtype: torch.dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex)


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The probe accumulator of ``dtype``'s data: float64 for f64/c128,
    float32 for the other inexact dtypes, int64 (wrapped afterwards, see
    :func:`probe_stats`) for exact ones."""
    if _exact(dtype):
        return torch.int64
    if dtype in (torch.float64, torch.complex128):
        return torch.float64
    return torch.float32


def _chunks(x: torch.Tensor):
    """Slices of ``x`` along its leading dim, each at most about
    :data:`_CHUNK` elements (one leading row when a row is larger)."""
    if x.dim() == 0 or x.numel() <= _CHUNK:
        yield x
        return
    row = max(1, x.numel() // x.shape[0])
    step = max(1, _CHUNK // row)
    for i in range(0, x.shape[0], step):
        yield x[i:i + step]


def _nonfinite(x: torch.Tensor) -> torch.Tensor:
    """Nonfinite elements of ``x`` as an int64 tensor on its device
    (chunked: the mask of one chunk at a time)."""
    total = torch.zeros((), dtype=torch.int64, device=x.device)
    if _exact(x.dtype):
        return total
    for c in _chunks(x):
        total += (~torch.isfinite(c)).sum()
    return total


def probe_stats(x: torch.Tensor, finite: bool = False) -> torch.Tensor:
    """The invariant probe of one block: ``[sum_re, sum_im, abs_sum,
    nonfinite]`` on ``x``'s device, in :func:`acc_dtype` (exact dtypes:
    unwrapped int64 partial sums; :func:`reduce_probes` sums them over
    the ranks and wraps them).  ``nonfinite`` is counted only when
    ``finite`` (the sampled tap)."""
    acc = acc_dtype(x.dtype)
    with torch.no_grad():
        x = x.detach()
        if _exact(x.dtype):
            s = torch.zeros((), dtype=torch.int64, device=x.device)
            a = torch.zeros((), dtype=torch.int64, device=x.device)
            for c in _chunks(x):
                ci = c.to(torch.int64)
                s += ci.sum()
                a += ci.abs_().sum()
            zero = torch.zeros((), dtype=torch.int64, device=x.device)
            return torch.stack([s, zero, a, zero])
        if x.is_complex():
            xr = torch.view_as_real(x)
            s_re = torch.sum(xr[..., 0], dtype=acc)
            s_im = torch.sum(xr[..., 1], dtype=acc)
            s_abs = torch.linalg.vector_norm(xr, 1, dtype=acc)
        else:
            s_re = torch.sum(x, dtype=acc)
            s_im = torch.zeros((), dtype=acc, device=x.device)
            s_abs = torch.linalg.vector_norm(x, 1, dtype=acc)
        nf = (_nonfinite(x).to(acc) if finite
              else torch.zeros((), dtype=acc, device=x.device))
        return torch.stack([s_re, s_im, s_abs, nf])


def _wrap(v: int, bits: int) -> int:
    """Two's-complement wrap of ``v`` to ``bits`` bits."""
    half = 1 << (bits - 1)
    return ((v + half) % (1 << bits)) - half


def reduce_probes(probes, dtype: torch.dtype, group=None) -> list:
    """Sum probe vectors over the ranks of ``group`` (one ``all_reduce``
    of all of them together; none without a group of more than one
    rank), fetch them to the host (waiting for the card's stream: the
    point a hung hop parks at) and return each as a float64 numpy array.
    Exact dtypes' sums wrap here: to 32 bits for elements of at most 32
    bits, else to 64."""
    flat = torch.cat([p.reshape(-1) for p in probes])
    if group is not None and dist.get_world_size(group) > 1:
        dist.all_reduce(flat, group=group)
    host = flat.cpu()
    out = []
    if _exact(dtype):
        bits = 32 if torch.empty((), dtype=dtype).element_size() <= 4 \
            else 64
        vals = [_wrap(int(v), bits) for v in host.tolist()]
        arr = np.asarray(vals, dtype=np.float64)
    else:
        arr = host.numpy().astype(np.float64)
    for i in range(len(probes)):
        out.append(arr[4 * i:4 * i + 4])
    return out


def _default_rtol(count: int, dtype) -> float:
    """Tolerance of the content-sum compare: zero for exact dtypes; for
    inexact ones the accumulator's epsilon scaled by the reduction
    depth plus a margin (override ``PENCILARRAYS_TPU_GUARD_RTOL``)."""
    from ..parallel.arrays import as_torch_dtype

    dt = as_torch_dtype(dtype)
    if _exact(dt):
        return 0.0
    from ..engine import config as _rtc

    rtol = _rtc.current().guard_rtol     # PENCILARRAYS_TPU_GUARD_RTOL
    if rtol is not None:
        return rtol
    eps = torch.finfo(acc_dtype(dt)).eps
    return eps * (8.0 + 4.0 * math.log2(max(2, count)))


def _component_ok(a: float, b: float, tol_abs: float) -> bool:
    if np.isnan(a) and np.isnan(b):
        return True       # NaN flowed through unchanged: movement, not birth
    if a == b:
        return True       # covers matching infinities and the exact case
    if not (np.isfinite(a) and np.isfinite(b)):
        return False      # a nonfinite value was born (or lost) in the hop
    return abs(a - b) <= tol_abs


def probes_match(pre, post, count: int, dtype, *, finite: bool = False,
                 wire_dtype: Optional[str] = None,
                 wire_hops: int = 1) -> Tuple[bool, str]:
    """Host-side compare of a probe pair: ``(ok, kind)`` with ``kind``
    ``"sum"``, ``"wire"`` or ``"nonfinite"`` for the failing check.  A
    ``wire_dtype`` hop widens the content-sum tolerance by the wire
    format's modeled rtol (``parallel/wire.py`` ``wire_rtol``) times
    ``wire_hops``; exceeding the widened tolerance is ``"wire"``."""
    from ..parallel.wire import wire_rtol

    pre = np.asarray(pre, dtype=np.float64)
    post = np.asarray(post, dtype=np.float64)
    rtol = _default_rtol(count, dtype)
    if wire_dtype is not None:
        rtol += max(1, int(wire_hops)) * wire_rtol(wire_dtype, count)
    tol_abs = rtol * (abs(pre[2]) + 1.0)
    for i in (0, 1, 2):
        if not _component_ok(float(pre[i]), float(post[i]), tol_abs):
            return False, "wire" if wire_dtype is not None else "sum"
    if finite and int(pre[3]) != int(post[3]):
        return False, "nonfinite"
    return True, "ok"


def _dtype_name(dtype) -> str:
    from ..parallel.arrays import as_torch_dtype

    return str(as_torch_dtype(dtype)).split(".")[-1]


def check_hop_probes(hop: str, pre, post, count: int, dtype, *,
                     finite: bool = False,
                     wire_dtype: Optional[str] = None,
                     wire_hops: int = 1,
                     ctx: Optional[dict] = None) -> None:
    """Verify one guarded hop's host-side probe pair; on mismatch journal
    ``guard.sdc``, write a crash bundle and raise :class:`IntegrityError`
    (:class:`WirePrecisionError` for a wired hop beyond its quantization
    tolerance).  On success bump ``guard.checks{outcome="ok"}`` only."""
    from .. import obs

    ok, kind = probes_match(pre, post, count, dtype, finite=finite,
                            wire_dtype=wire_dtype, wire_hops=wire_hops)
    if ok:
        if obs.enabled():
            obs.counter("guard.checks", outcome="ok").inc()
        return
    predicted = [float(v) for v in np.asarray(pre)]
    observed = [float(v) for v in np.asarray(post)]
    extra_ctx = dict(ctx or {})
    if wire_dtype is not None:
        extra_ctx.setdefault("wire_dtype", wire_dtype)
        extra_ctx.setdefault("wire_hops", wire_hops)
    if obs.enabled():
        obs.counter("guard.checks", outcome=kind).inc()
        obs.record_event("guard.sdc", hop=hop, kind=kind,
                         predicted=predicted, observed=observed,
                         count=count, dtype=_dtype_name(dtype),
                         **extra_ctx)
    from .bundle import write_crash_bundle

    bundle = write_crash_bundle(
        "sdc", hop,
        error=f"{kind} invariant mismatch: {predicted} -> {observed}",
        extra={"predicted": predicted, "observed": observed,
               "kind": kind, **extra_ctx})
    if kind == "wire":
        raise WirePrecisionError(
            f"wire-precision tolerance exceeded on {hop}: content-sum "
            f"drift beyond the {wire_dtype} quantization model across "
            f"{wire_hops} packed exchange(s) (predicted {predicted}, "
            f"observed {observed}; crash bundle: "
            f"{bundle or 'unavailable'})",
            hop=hop, predicted=predicted, observed=observed, kind=kind,
            bundle=bundle, wire_dtype=wire_dtype)
    raise IntegrityError(
        f"silent data corruption detected on {hop}: {kind} invariant "
        f"mismatch (predicted {predicted}, observed {observed}; crash "
        f"bundle: {bundle or 'unavailable'})",
        hop=hop, predicted=predicted, observed=observed, kind=kind,
        bundle=bundle)


# ---------------------------------------------------------------------------
# deterministic SDC drills (the faults `corrupt` mode payload)
# ---------------------------------------------------------------------------


def _poke_flat(flat: torch.Tensor, i: int) -> None:
    """Corrupt element ``i`` of a flat view in place: NaN for inexact
    dtypes (a complex element becomes ``nan + 0j``), the sign bit
    flipped for exact ones (bool: negated)."""
    dt = flat.dtype
    if dt.is_complex:
        flat[i] = complex(float("nan"), 0.0)
    elif dt.is_floating_point:
        flat[i] = float("nan")
    elif dt == torch.bool:
        flat[i] = ~flat[i]
    else:
        bits = torch.iinfo(dt).bits
        # the sign bit as a value of the dtype: min for signed
        # (0b100...0), 2**(bits-1) for unsigned
        signbit = torch.iinfo(dt).min if torch.iinfo(dt).min < 0 \
            else 1 << (bits - 1)
        flat[i] = flat[i] ^ torch.tensor(signbit, dtype=dt,
                                         device=flat.device)


def corrupt_block(x: torch.Tensor, idx: int) -> torch.Tensor:
    """Counter-addressed corruption of one element of a whole array, in
    place: flat index ``idx % size``.  Returns ``x``."""
    n = x.numel()
    if n:
        with torch.no_grad():
            _poke_flat(x.view(-1), int(idx) % n)
    return x


def corrupt_array(pencil, data: torch.Tensor, extra_dims, idx: int
                  ) -> torch.Tensor:
    """The poke of :func:`corrupt_block` on a distributed array: element
    ``idx % size`` of the flat padded global array (the pencil's padded
    global shape in memory order, then the extra dims — the JAX
    package's array), poked in place on the rank whose block holds it.
    Returns ``data``."""
    from ..parallel.pencil import MemoryOrder

    gshape = tuple(pencil.padded_size_global(MemoryOrder)) \
        + tuple(extra_dims)
    total = math.prod(gshape)
    if not total:
        return data
    g = np.unravel_index(int(idx) % total, gshape)
    N = pencil.ndims
    mem_to_logical = pencil.permutation.apply(tuple(range(N)))
    lshape = tuple(data.shape)
    coords = pencil.topology.coords_local
    local = list(g)
    for j in range(N):
        d = mem_to_logical[j]
        if d in pencil.decomposition:
            slot = pencil.decomposition.index(d)
            if g[j] // lshape[j] != coords[slot]:
                return data       # another rank's block holds it
            local[j] = g[j] % lshape[j]
    with torch.no_grad():
        _poke_flat(data.view(-1),
                   int(np.ravel_multi_index(tuple(local), lshape)))
    return data


def corrupt_eager(x, hit: int):
    """Apply the poke, addressed by a fault rule's hit counter, to a
    tensor (:func:`corrupt_block`) or a PencilArray
    (:func:`corrupt_array`), in place; returns ``x``."""
    idx = max(0, int(hit))
    if isinstance(x, torch.Tensor):
        return corrupt_block(x, idx)
    corrupt_array(x.pencil, x.data, x.extra_dims, idx)
    return x


# ---------------------------------------------------------------------------
# finiteness boundary tap (the "NaN born mid-FFT" detector)
# ---------------------------------------------------------------------------


def nonfinite_count(x, group=None) -> int:
    """Nonfinite elements of a tensor (0 for exact dtypes), summed over
    the ranks of ``group`` when it has more than one; counted chunked."""
    n = _nonfinite(x.detach())
    if group is not None and dist.get_world_size(group) > 1:
        dist.all_reduce(n, group=group)
    return int(n)


def report_nonfinite_birth(label: str, nf_out: int,
                           ctx: Optional[dict] = None) -> None:
    """A section whose input was finite produced ``nf_out`` nonfinite
    values: journal ``guard.sdc`` (``kind="nonfinite"``), write a crash
    bundle and raise :class:`IntegrityError`.  With ``nf_out`` 0 only the
    ok counter moves."""
    from .. import obs

    if nf_out == 0:
        if obs.enabled():
            obs.counter("guard.checks", outcome="ok").inc()
        return
    if obs.enabled():
        obs.counter("guard.checks", outcome="nonfinite").inc()
        obs.record_event("guard.sdc", hop=label, kind="nonfinite",
                         predicted=[0], observed=[nf_out], **(ctx or {}))
    from .bundle import write_crash_bundle

    bundle = write_crash_bundle(
        "sdc", label,
        error=f"{nf_out} nonfinite value(s) born inside {label}",
        extra={"nonfinite": nf_out, **(ctx or {})})
    raise IntegrityError(
        f"{nf_out} nonfinite value(s) born inside {label} from finite "
        f"input (crash bundle: {bundle or 'unavailable'})",
        hop=label, predicted=[0], observed=[nf_out], kind="nonfinite",
        bundle=bundle)


def check_finite_boundary(label: str, x_in, x_out,
                          ctx: Optional[dict] = None, group=None) -> None:
    """Sampled transform-boundary tap: a nonfinite value in the output
    but none in the input was born inside the section; journal, bundle
    and raise (:func:`report_nonfinite_birth`).  An input that already
    holds nonfinite values passes ungated."""
    if nonfinite_count(x_in, group) > 0:
        return
    report_nonfinite_birth(label, nonfinite_count(x_out, group), ctx)
