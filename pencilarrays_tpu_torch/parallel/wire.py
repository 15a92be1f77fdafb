"""Reduced-precision wire formats: the pack and unpack around an exchange.

PyTorch counterpart of the JAX package's ``parallel/wire.py``.  An
exchange method may carry ``wire_dtype="bf16" | "f16" | "fp8_e4m3" |
"fp8_e5m2"``: each payload is cast down just before its exchange call and
restored just after, and everything around it stays in full precision.
The payload travels as the wire format's bit pattern (``uint16`` or
``uint8``), so the exchange moves exactly :func:`wire_bytes`.

* **Packing.**  Real payloads cast elementwise; complex payloads split into
  re/im along a new trailing axis.  The fp8 formats scale per tile: the
  payload is cut along its tile axis (:func:`fp8_tile_axis`, an axis the
  exchange does not touch) into windows of :data:`FP8_TILE` elements, each
  window maps its finite max-abs onto the format's largest value, and its
  f32 scale rides the same buffer, 4 bytes a window appended along the tile
  axis.
* **JAX's bits.**  On the CPU, :func:`pack` gives the bytes of the JAX
  package's ``pack`` as its exchanges run it, traced into a jitted program
  on XLA:CPU, and :func:`unpack` its values.  Two kinds of difference are
  handled by explicit torch ops:

  - *the wire's contract*, on every device: torch's casts differ from
    XLA's at the edges, so the port writes JAX's NaN patterns of every
    format and e4m3's NaN for an infinity (torch saturates inf to 448 in
    e4m3fn; its bf16 and e5m2 NaNs have other bits), rounds f64 to f16 and
    fp8 once as XLA does (torch rounds through f32 twice: the port rounds
    to odd into f32 first), and scales by the product with the
    reciprocal of the format's maximum, as XLA rewrites the jitted
    division (no extra pass);
  - *XLA:CPU's flush-to-zero* (``ftz``): subnormal inputs to the scale
    arithmetic, subnormal window scales and products, the f32 step of an
    f64 -> bf16 cast, and x86's negative default NaN.  This belongs to
    the reference's test platform, not to the wire, and it costs eager
    passes, so it is on only for tensors on the CPU (``ftz=None``).  On
    the card the wire keeps IEEE subnormals, and a window whose scale
    XLA:CPU would flush to zero (and decode as zeros or NaN) keeps its
    values.  Inputs with no subnormal in the scale arithmetic give the
    same bytes either way.
* **Accounting.**  :func:`wire_itemsize`, :func:`wire_bytes`,
  :func:`cast_score_bytes` and :func:`wire_rtol` are the JAX package's
  formulas; the cost model, the route planner and the FFT planner share
  them.

The functions that work on the port's exchange layout take the tile axis
directly (:func:`pack_axis`, :func:`unpack_axis`): K1 packs the ``P``
tiles of a hop in the output's memory order, and the windows must hold the
elements JAX's windows hold, which lie along the same logical axis.  On
the card this costs several eager passes per pack; a fused K1-and-cast
pack is queued (ROADMAP Queue 1, item 2).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "WIRE_DTYPES",
    "FP8_WIRE_DTYPES",
    "FP8_TILE",
    "canonical_wire_dtype",
    "fp8_tile_axis",
    "pack",
    "unpack",
    "pack_axis",
    "unpack_axis",
    "wire_itemsize",
    "wire_bytes",
    "cast_score_bytes",
    "wire_rtol",
]

WIRE_DTYPES = ("bf16", "f16", "fp8_e4m3", "fp8_e5m2")
FP8_WIRE_DTYPES = ("fp8_e4m3", "fp8_e5m2")

# machine epsilon of each wire format (2^-mantissa_bits)
_WIRE_EPS = {"bf16": 2.0 ** -8, "f16": 2.0 ** -11,
             "fp8_e4m3": 2.0 ** -3, "fp8_e5m2": 2.0 ** -2}
# OCP FP8: e4m3fn max finite 448 (no inf), e5m2 max finite 57344
_FP8_FMAX = {"fp8_e4m3": 448.0, "fp8_e5m2": 57344.0}
# smallest positive subnormal of each fp8 format
_FP8_SUB = {"fp8_e4m3": 2.0 ** -9, "fp8_e5m2": 2.0 ** -16}
FP8_TILE = 256
# cast bytes are device-memory traffic, not link traffic: the planners'
# bytes-equivalent score discounts them by this factor (the JAX package's)
CAST_BYTES_WEIGHT = 0.125

_WIRE_ALIASES = {
    "bfloat16": "bf16", "float16": "f16", "half": "f16",
    "e4m3": "fp8_e4m3", "float8_e4m3": "fp8_e4m3",
    "float8_e4m3fn": "fp8_e4m3", "fp8-e4m3": "fp8_e4m3",
    "e5m2": "fp8_e5m2", "float8_e5m2": "fp8_e5m2",
    "fp8-e5m2": "fp8_e5m2",
}

_TORCH_WIRE = {"bf16": "bfloat16", "f16": "float16",
               "fp8_e4m3": "float8_e4m3fn", "fp8_e5m2": "float8_e5m2"}

# JAX's bit patterns for NaN (and e4m3fn's +-inf, which it maps to NaN),
# positive sign; the sign bit is or-ed in per element
_NAN_BITS = {"bf16": 0x7FC0, "f16": 0x7E00, "fp8_e4m3": 0x7F,
             "fp8_e5m2": 0x7E}


def canonical_wire_dtype(wire_dtype) -> Optional[str]:
    """One of :data:`WIRE_DTYPES` or ``None``, from the canonical names,
    ``"bfloat16"``/``"float16"``, the fp8 spellings, or a torch or NumPy
    dtype; anything else raises ``ValueError``."""
    if wire_dtype is None:
        return None
    if isinstance(wire_dtype, str):
        name = wire_dtype.strip().lower()
    elif isinstance(wire_dtype, torch.dtype):
        name = str(wire_dtype).split(".")[-1]
    else:
        try:
            name = np.dtype(wire_dtype).name
        except TypeError:
            name = repr(wire_dtype)
    name = _WIRE_ALIASES.get(name, name)
    if name not in WIRE_DTYPES:
        raise ValueError(
            f"wire_dtype must be None or one of {WIRE_DTYPES}, got "
            f"{wire_dtype!r}")
    if not hasattr(torch, _TORCH_WIRE[name]):
        raise ValueError(f"wire_dtype={name!r} needs torch."
                         f"{_TORCH_WIRE[name]}, which this torch lacks")
    return name


def _torch_wire(wire: str) -> torch.dtype:
    return getattr(torch, _TORCH_WIRE[wire])


def _bits_dtype(wire: str) -> torch.dtype:
    return torch.uint8 if wire in FP8_WIRE_DTYPES else torch.int16


def _kind_itemsize(dtype) -> Tuple[str, int]:
    """(NumPy kind letter, itemsize) of a torch or NumPy dtype."""
    if dtype is None:
        return "f", 4
    if isinstance(dtype, torch.dtype):
        size = torch.empty((), dtype=dtype).element_size()
        kind = ("c" if dtype.is_complex else
                "f" if dtype.is_floating_point else "i")
        return kind, size
    dt = np.dtype(dtype)
    return dt.kind, dt.itemsize


def fp8_tile_axis(shape: Sequence[int], a: int, b: int) -> int:
    """The largest axis of the pre-pack payload shape that is neither the
    concat dim ``a`` nor the split dim ``b``, ties to the lowest index;
    raises when there is none (a 2-D exchange operand needs a 16-bit
    wire)."""
    best, best_n = -1, -1
    for i, n in enumerate(shape):
        if i == a or i == b:
            continue
        if int(n) > best_n:
            best, best_n = i, int(n)
    if best < 0:
        raise ValueError(
            f"fp8 wire needs a tile axis outside the exchange axes "
            f"(a={a}, b={b}), but shape {tuple(shape)} has no free "
            f"axis — use a 16-bit wire for 2-D exchange operands")
    return best


def _split_complex(x: torch.Tensor) -> torch.Tensor:
    if x.is_complex():
        return torch.view_as_real(x.resolve_conj())
    if not x.is_floating_point():
        raise TypeError(
            f"a reduced-precision wire needs an inexact payload dtype; "
            f"got {x.dtype} (exact dtypes have no lossy wire form)")
    return x


def _tiny(dtype: torch.dtype) -> float:
    return torch.finfo(dtype).tiny


def _flush(x: torch.Tensor) -> torch.Tensor:
    """Subnormals of ``x``'s own type to zero of their sign (XLA:CPU's
    flush-to-zero and denormals-are-zero)."""
    return torch.where(x.abs() < _tiny(x.dtype), torch.zeros_like(x) * x,
                       x)


def _recip(v: float, dtype: torch.dtype) -> float:
    """``1 / v`` rounded to ``dtype`` (f32 or f64), as a Python float."""
    return float(np.float32(1.0 / v)) if dtype == torch.float32 \
        else 1.0 / v


def _round_to_odd_f32(x: torch.Tensor) -> torch.Tensor:
    """f64 -> f32 rounded to odd: a later round-to-nearest cast to a
    format of 22 bits or fewer is then the single correct rounding of the
    f64 value (XLA converts f64 to f16 and fp8 directly; torch goes
    through a rounded f32)."""
    f = x.to(torch.float32)
    back = f.to(torch.float64)
    inexact = (back != x) & torch.isfinite(x)
    away = inexact & (back.abs() > x.abs())
    bits = f.view(torch.int32)
    bits = torch.where(inexact, (bits - away.to(torch.int32)) | 1, bits)
    return bits.view(torch.float32)


def _signed(v: int, bits: int) -> int:
    return v - (1 << bits) if v >= 1 << (bits - 1) else v


def _nan_pattern(wire: str, neg: torch.Tensor) -> torch.Tensor:
    """JAX's NaN pattern of the format with the sign of ``neg``, in the
    wire's integer type."""
    width = 8 if wire in FP8_WIRE_DTYPES else 16
    pos = _NAN_BITS[wire]
    sgn = pos | (1 << (width - 1))
    dt = _bits_dtype(wire)
    if width == 16:
        pos, sgn = _signed(pos, 16), _signed(sgn, 16)
    return torch.where(neg, torch.tensor(sgn, dtype=dt, device=neg.device),
                       torch.tensor(pos, dtype=dt, device=neg.device))


def _to_wire(vals: torch.Tensor, wire: str, nan_neg: torch.Tensor,
             ftz: bool) -> torch.Tensor:
    """``vals`` cast to the wire format as XLA casts it, as its integer
    bit pattern (``int16`` or ``uint8``); NaN lanes take JAX's NaN pattern
    with the sign ``nan_neg``, and so do e4m3's infinities."""
    src = vals
    if vals.dtype == torch.float64:
        # XLA goes f64 -> f32 (XLA:CPU flushing subnormal results) ->
        # bf16, and rounds f64 -> f16 / fp8 once
        if wire == "bf16":
            src = vals.to(torch.float32)
            if ftz:
                src = _flush(src)
        else:
            src = _round_to_odd_f32(vals)
    q = src.to(_torch_wire(wire)).view(_bits_dtype(wire))
    if wire == "fp8_e4m3":
        # e4m3fn has no infinity: JAX gives NaN, torch saturates to 448
        q = torch.where(torch.isinf(vals),
                        _nan_pattern(wire, torch.signbit(vals)), q)
    return torch.where(torch.isnan(vals), _nan_pattern(wire, nan_neg), q)


_SLAB = 1 << 24
"""Elements a 16-bit cast scans at a time for NaN lanes (its temporaries
are a few bytes an element of one slab)."""


def _nan_lanes(vals: torch.Tensor, negative) -> list:
    """``(flat indices, negative?)`` of the NaN lanes of the 1-D float
    tensor ``vals``: none when its maximum, which a NaN makes NaN, is not;
    else found a slab at a time (``negative(indices)``)."""
    if not vals.numel() or not torch.isnan(torch.amax(vals)):
        return []
    lanes = []
    for s in range(0, vals.numel(), _SLAB):
        idx = torch.isnan(vals[s:s + _SLAB]).nonzero().squeeze(1) + s
        if idx.numel():
            lanes.append((idx, negative(idx)))
    return lanes


def _pack16(parts: torch.Tensor, wire: str, ftz: bool) -> torch.Tensor:
    """``_to_wire`` of a 16-bit wire with no full-size temporary for f32
    ``parts``: the NaN lanes are found before the wire buffer exists, the
    buffer takes torch's cast in one pass (a copy between dtypes), and
    the NaN lanes then take JAX's pattern; other inputs take
    ``_to_wire``."""
    if parts.dtype != torch.float32 or not parts.is_contiguous():
        return _to_wire(parts, wire, torch.signbit(parts), ftz)
    flat = parts.view(-1)
    lanes = _nan_lanes(flat, lambda i: torch.signbit(flat[i]))
    out = torch.empty(parts.shape, dtype=_torch_wire(wire),
                      device=parts.device)
    out.copy_(parts)
    bits = out.view(torch.int16)
    for idx, neg in lanes:
        bits.view(-1)[idx] = _nan_pattern(wire, neg)
    return bits


def _unpack16(y: torch.Tensor, real_dt: torch.dtype, wire: str,
              ftz: bool) -> torch.Tensor:
    """The 16-bit words ``y`` (int16) widened to ``real_dt``, NaN lanes as
    XLA widens them with the sign read from the bits (a device's widening
    cast may drop it); into one f32 buffer with no full-size temporary
    when ``real_dt`` is f32."""
    w = y.view(_torch_wire(wire))
    if real_dt != torch.float32 or not y.is_contiguous():
        if wire == "bf16" and real_dt == torch.float64 and ftz:
            # XLA:CPU widens bf16 -> f32 -> f64 and flushes on the way
            parts = _flush(w.to(torch.float32)).to(torch.float64)
        else:
            parts = w.to(real_dt)
        return _canonical_nan(parts, y < 0)
    flat = y.view(-1)
    lanes = _nan_lanes(w.view(-1), lambda i: flat[i] < 0)
    out = torch.empty(y.shape, dtype=torch.float32, device=y.device)
    out.copy_(w)
    bits = out.view(torch.int32).view(-1)
    for idx, neg in lanes:
        bits[idx] = torch.where(
            neg, torch.tensor(_signed(0xFFC00000, 32), device=y.device),
            torch.tensor(0x7FC00000, device=y.device)).to(torch.int32)
    return out


def _canonical_nan(x: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """NaN lanes of ``x`` (f32 or f64) as the quiet NaN of sign ``neg``
    that XLA:CPU produces."""
    if x.dtype == torch.float32:
        it, pos, sgn = torch.int32, 0x7FC00000, _signed(0xFFC00000, 32)
    else:
        it, pos, sgn = torch.int64, 0x7FF8000000000000, \
            _signed(0xFFF8000000000000, 64)
    pat = torch.where(neg, torch.tensor(sgn, dtype=it, device=x.device),
                      torch.tensor(pos, dtype=it, device=x.device))
    return torch.where(torch.isnan(x), pat.view(x.dtype), x)


def _tile_segments(n_t: int):
    """``(first_tile, tiles, length)`` of the whole windows and the
    ragged tail of an axis of ``n_t`` elements."""
    full, rem = divmod(n_t, FP8_TILE)
    segs = []
    if full:
        segs.append((0, full, FP8_TILE))
    if rem:
        segs.append((full, 1, rem))
    return segs


def _reinterpret_last(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t``'s bytes as ``dtype``, the last axis rescaled by the size
    ratio (little-endian, JAX's ``bitcast_convert_type`` order)."""
    flat = t.contiguous().reshape(-1).view(dtype)
    return flat.reshape(tuple(t.shape[:-1]) + (-1,))


def _split_axis(t: torch.Tensor, axis: int, k: int, L: int) -> torch.Tensor:
    """A view of ``t`` with axis ``axis`` (extent ``k * L``) split into
    ``(k, L)``."""
    return t.unflatten(axis, (k, L))


def _fp8_pack_parts(parts: torch.Tensor, wire: str, t: int,
                    ftz: bool) -> torch.Tensor:
    fmax = _FP8_FMAX[wire]
    n_t = parts.shape[t]
    ntiles = -(-n_t // FP8_TILE)
    out_shape = list(parts.shape)
    out_shape[t] = n_t + 4 * ntiles
    out = torch.empty(out_shape, dtype=torch.uint8, device=parts.device)
    sshape = list(parts.shape)
    sshape[t] = ntiles
    scale = torch.empty(sshape, dtype=torch.float32, device=parts.device)
    one = torch.ones((), dtype=torch.float32, device=parts.device)
    for k0, k, L in _tile_segments(n_t):
        seg = _split_axis(parts.narrow(t, k0 * FP8_TILE, k * L), t, k, L)
        finite = torch.isfinite(seg)
        absx = torch.where(finite, seg.abs(), torch.zeros_like(seg))
        amax = absx.amax(dim=t + 1)
        del absx
        # the division by the constant is a product with its reciprocal,
        # rounded to the payload's type (XLA's rewrite in a jitted program)
        s = (amax * _recip(fmax, amax.dtype)).to(torch.float32)
        if ftz:
            # XLA:CPU compares and divides subnormals as zero, and
            # flushes a subnormal f32 scale (a zero scale then stays)
            amax = _flush(amax)
            s = torch.where(amax > 0, _flush(s), one)
            src = _flush(seg)
            # 0/0 (a flushed scale) gives x86's default NaN, negative
            nan_neg = torch.where(torch.isnan(seg), torch.signbit(seg),
                                  torch.ones((), dtype=torch.bool,
                                             device=seg.device))
        else:
            s = torch.where(s > 0, s, one)
            src, nan_neg = seg, torch.signbit(seg)
        scale.narrow(t, k0, k).copy_(s)
        scaled = src / s.to(seg.dtype).unsqueeze(t + 1)
        del src
        q = torch.where(finite, scaled.clamp(-fmax, fmax), scaled)
        del scaled
        _split_axis(out.narrow(t, k0 * FP8_TILE, k * L), t, k, L).copy_(
            _to_wire(q, wire, nan_neg, ftz))
    out.narrow(t, n_t, 4 * ntiles).copy_(
        _reinterpret_last(scale.movedim(t, -1), torch.uint8).movedim(-1, t))
    return out


def _real_dtype(dtype: torch.dtype) -> torch.dtype:
    return {torch.complex64: torch.float32,
            torch.complex128: torch.float64}.get(dtype, dtype)


def _fp8_unpack_parts(y: torch.Tensor, real_dt: torch.dtype, wire: str,
                      t: int, n_t: int, ftz: bool) -> torch.Tensor:
    ntiles = -(-n_t // FP8_TILE)
    scale = _reinterpret_last(y.narrow(t, n_t, 4 * ntiles).movedim(t, -1),
                              torch.float32).movedim(-1, t).to(real_dt)
    bits = y.narrow(t, 0, n_t)
    vals = bits.view(_torch_wire(wire)).to(real_dt)
    out = torch.empty(vals.shape, dtype=real_dt, device=y.device)
    for k0, k, L in _tile_segments(n_t):
        v = _split_axis(vals.narrow(t, k0 * FP8_TILE, k * L), t, k, L)
        r = v * scale.narrow(t, k0, k).unsqueeze(t + 1)
        # a NaN payload keeps its sign, read from its bits (a widening
        # cast of NaN may drop it)
        neg = _split_axis(bits.narrow(t, k0 * FP8_TILE, k * L), t, k,
                          L) >= 0x80
        if ftz:
            if real_dt == torch.float32:
                r = _flush(r)
            # inf * 0 (a flushed scale) gives x86's default NaN, negative
            neg = torch.where(torch.isnan(v), neg,
                              torch.ones((), dtype=torch.bool,
                                         device=v.device))
        _split_axis(out.narrow(t, k0 * FP8_TILE, k * L), t, k, L).copy_(
            _canonical_nan(r, neg))
    return out


def _ftz(x: torch.Tensor, ftz: Optional[bool]) -> bool:
    """XLA:CPU's flush-to-zero: by default on for tensors on the CPU."""
    return x.device.type == "cpu" if ftz is None else bool(ftz)


def pack_axis(x: torch.Tensor, wire_dtype, tile_axis: Optional[int] = None,
              *, ftz: Optional[bool] = None) -> torch.Tensor:
    """:func:`pack` with the fp8 tile axis given directly (ignored on a
    16-bit wire): the port's exchange packs K1's tile layout, whose tile
    axis is JAX's tile axis at its memory-order position.  ``ftz``:
    XLA:CPU's flush-to-zero, by default on for a tensor on the CPU."""
    wire = canonical_wire_dtype(wire_dtype)
    ftz = _ftz(x, ftz)
    parts = _split_complex(x)
    if wire in FP8_WIRE_DTYPES:
        if tile_axis is None:
            raise ValueError(f"wire_dtype={wire!r} needs a tile axis")
        return _fp8_pack_parts(parts, wire, int(tile_axis), ftz)
    return _pack16(parts, wire, ftz).view(torch.uint16)


def unpack_axis(y: torch.Tensor, orig_dtype, wire_dtype,
                tile_axis: Optional[int] = None,
                n_t: Optional[int] = None, *,
                ftz: Optional[bool] = None) -> torch.Tensor:
    """Inverse of :func:`pack_axis`; an fp8 wire needs the tile axis and
    its pre-pack extent ``n_t``."""
    from .arrays import as_torch_dtype

    wire = canonical_wire_dtype(wire_dtype)
    ftz = _ftz(y, ftz)
    orig = as_torch_dtype(orig_dtype)
    real_dt = _real_dtype(orig)
    if wire in FP8_WIRE_DTYPES:
        if tile_axis is None or n_t is None:
            raise ValueError(f"wire_dtype={wire!r} unpack needs the tile "
                             f"axis and its extent")
        parts = _fp8_unpack_parts(y, real_dt, wire, int(tile_axis), int(n_t),
                                  ftz)
    else:
        parts = _unpack16(y.view(torch.int16), real_dt, wire, ftz)
    if orig.is_complex:
        return torch.view_as_complex(parts.contiguous())
    return parts.to(orig)


def pack(x: torch.Tensor, wire_dtype, *,
         axes: Optional[Tuple[int, int]] = None,
         ftz: Optional[bool] = None) -> torch.Tensor:
    """Cast one exchange payload of logical shape down to its wire format:
    the JAX package's ``pack``, byte for byte (``uint16`` on a 16-bit
    wire, ``uint8`` with the scales appended along the tile axis on an
    fp8 wire, which needs the exchange's ``axes=(a, b)``); ``ftz`` as in
    :func:`pack_axis`."""
    wire = canonical_wire_dtype(wire_dtype)
    t = None
    if wire in FP8_WIRE_DTYPES:
        if axes is None:
            raise ValueError(
                f"wire_dtype={wire!r} needs axes=(a, b) to derive its "
                f"tile axis — fp8 pack is exchange-geometry aware")
        t = fp8_tile_axis(x.shape, int(axes[0]), int(axes[1]))
    return pack_axis(x, wire, t, ftz=ftz)


def unpack(y: torch.Tensor, orig_dtype, wire_dtype, *,
           axes: Optional[Tuple[int, int]] = None,
           orig_shape: Optional[Sequence[int]] = None,
           ftz: Optional[bool] = None) -> torch.Tensor:
    """Restore a packed payload to ``orig_dtype`` (the JAX package's
    ``unpack``); an fp8 wire needs the ``axes`` of :func:`pack` and the
    pre-pack ``orig_shape``."""
    wire = canonical_wire_dtype(wire_dtype)
    t = n_t = None
    if wire in FP8_WIRE_DTYPES:
        if axes is None or orig_shape is None:
            raise ValueError(
                f"wire_dtype={wire!r} unpack needs axes=(a, b) and the "
                f"pre-pack orig_shape to re-derive its tile geometry")
        t = fp8_tile_axis(orig_shape, int(axes[0]), int(axes[1]))
        n_t = int(orig_shape[t])
    return unpack_axis(y, orig_dtype, wire, t, n_t, ftz=ftz)


def wire_itemsize(dtype, wire_dtype) -> int:
    """Payload wire bytes per exchanged logical element: the dtype's own
    itemsize without a wire, 2 bytes per real component on bf16/f16, 1 on
    fp8 (whose per-tile scales :func:`wire_bytes` adds)."""
    kind, size = _kind_itemsize(dtype)
    if wire_dtype is None:
        return size
    wire = canonical_wire_dtype(wire_dtype)
    if kind not in "fc":
        raise TypeError(
            f"wire_dtype={wire_dtype!r} needs an inexact payload dtype; "
            f"got {dtype} (exact dtypes have no lossy wire form)")
    per = 1 if wire in FP8_WIRE_DTYPES else 2
    return 2 * per if kind == "c" else per


def wire_bytes(dtype, wire_dtype, shape: Sequence[int], *,
               axes: Optional[Tuple[int, int]] = None) -> int:
    """Wire bytes of one exchanged operand of logical ``shape``, the fp8
    scales included (4 bytes per window along the tile axis, which needs
    the exchange ``axes=(a, b)``)."""
    elems = 1
    for n in shape:
        elems *= int(n)
    w = wire_itemsize(dtype, wire_dtype)
    wire = canonical_wire_dtype(wire_dtype)
    if wire not in FP8_WIRE_DTYPES:
        return elems * w
    if axes is None:
        raise ValueError(
            f"wire_bytes on wire_dtype={wire!r} needs the exchange "
            f"axes=(a, b) to derive the tile axis — fp8 byte "
            f"accounting is exchange-geometry aware")
    t = fp8_tile_axis(shape, int(axes[0]), int(axes[1]))
    n_t = int(shape[t])
    rows = elems // max(1, n_t)
    return rows * (n_t + 4 * (-(-n_t // FP8_TILE))) * w


def cast_score_bytes(wire_nbytes: int, dtype, wire_dtype) -> int:
    """Bytes-equivalent toll of one hop's pack and unpack casts in the
    planners' score: each element read full and written wire, then read
    wire and written full, weighted by :data:`CAST_BYTES_WEIGHT`."""
    if wire_dtype is None or wire_nbytes <= 0:
        return 0
    w = wire_itemsize(dtype, wire_dtype)
    full = _kind_itemsize(dtype)[1]
    elems = wire_nbytes // max(1, w)
    return int(2 * elems * (full + w) * CAST_BYTES_WEIGHT)


def wire_rtol(wire_dtype, count: int) -> float:
    """Relative tolerance of the guard's content-sum compare of ``count``
    elements across one wire round trip (the JAX package's formula):
    half the format's epsilon, plus the fp8 windows' scale-granularity
    term (``TILE * sub / (2 * FMAX)``), times a small reduction-depth
    margin.  A wired hop beyond it raises
    :class:`~pencilarrays_tpu_torch.guard.errors.WirePrecisionError`.
    Override: ``PENCILARRAYS_TPU_GUARD_WIRE_RTOL`` (``engine/config.py``)."""
    if wire_dtype is None:
        return 0.0
    from ..engine import config as _rtc

    override = _rtc.current().guard_wire_rtol
    if override is not None:
        return override
    wire = canonical_wire_dtype(wire_dtype)
    base = 0.5 * _WIRE_EPS[wire]
    if wire in FP8_WIRE_DTYPES:
        base += FP8_TILE * _FP8_SUB[wire] / (2.0 * _FP8_FMAX[wire])
    return base * (1.0 + 0.25 * math.log2(max(2, count)))
