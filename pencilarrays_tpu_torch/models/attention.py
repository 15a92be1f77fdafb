"""Sequence-parallel attention on pencil primitives.

PyTorch counterpart of the JAX package's ``models/attention.py``:

* :func:`ulysses_attention` — DeepSpeed-Ulysses: q/k/v stacked, ONE
  :func:`~pencilarrays_tpu_torch.parallel.transpositions.transpose` to the
  head-decomposed pencil (sequence local), flash attention on the local
  head group, one transpose back.  Ragged ``H`` rides on the transpose's
  padding.
* :func:`ring_attention` — k/v blocks rotate around the ring
  (:func:`~pencilarrays_tpu_torch.parallel.transpositions.ring_shift`)
  while each rank merges one flash ``partials`` call per round; with
  ``zigzag=True`` (causal only) the balanced zigzag placement
  (:func:`to_zigzag`) does about half the naive causal work.

Layout and conventions follow the JAX package: raw arrays ``(S, H,
*batch, D)``, causal masks start-aligned by global position, rows with no
visible key return an unspecified finite value.

``impl`` selects the local computation:

* ``"kernel"`` (the JAX package's ``"pallas"``) — kernels K2–K4
  (:mod:`..ops.flash`) in ``torch.autograd.Function`` s: the forward with
  ``return_stats`` or ``partials``, the backward as K3 + K4 against the
  saved logsumexp.  On CPU tensors the same schedule runs the kernels'
  plain versions.  Raises where :func:`..ops.flash.supported` rejects
  the case.
* ``"plain"`` (the JAX package's ``"xla"``) — ``flash_attention`` streams
  k/v chunks with torch ops and differentiates them with autograd; the
  ring schedules run the kernels' plain per-block functions.
* ``"auto"`` (default) — ``"kernel"`` for every case ``supported()``
  takes (q, k and v each f32 or bf16, ``D % 8 == 0``, ``D <= 1024``),
  ``"plain"`` for the rest (an f16 or f64 operand, other head dims), on
  any device.  No other rule routes a case away from the kernels.

Rank and ring round are known on the host, so the ring offsets are Python
ints and the zigzag schedule's past/future choice is a plain ``if``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops import flash
from ..ops.flash import _fold, _score_dtype
from ..parallel.arrays import PencilArray
from ..parallel.topology import Topology
from ..parallel.transpositions import ring_shift, transpose

__all__ = [
    "ulysses_attention",
    "ring_attention",
    "dense_attention",
    "flash_attention",
    "to_zigzag",
    "from_zigzag",
    "zigzag_indices",
]

_IMPLS = ("auto", "plain", "kernel")


def _neg_value(dtype) -> float:
    """Finite masked-score value of the score dtype: half its most
    negative value, so ``exp(neg - m)`` is exactly 0 for any real running
    max and never -inf/NaN (float16's range included)."""
    return float(torch.finfo(dtype).min) / 2


def _check_impl(impl: str):
    if impl not in _IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; one of {_IMPLS}")


def _check_qkv(q: PencilArray, k: PencilArray, v: PencilArray):
    pen = q.pencil
    for name, x in (("k", k), ("v", v)):
        if x.pencil != pen or x.extra_dims != q.extra_dims:
            raise ValueError(f"{name} must share q's pencil and extra dims")
    if pen.ndims != 2:
        raise ValueError("attention pencils are (S, H); put the feature "
                         "dim in extra_dims")
    if len(q.extra_dims) < 1:
        raise ValueError("q/k/v need extra_dims=(*batch, head_dim)")
    if pen.padded_global_shape != pen.size_global():
        raise ValueError(
            "attention requires a shard-divisible sequence length S (the "
            "softmax must not see padded positions); pad the sequence "
            "yourself with masked tokens if needed")
    if not pen.permutation.is_identity():
        raise ValueError("attention requires identity permutation pencils")
    return pen


def _fold_batch(x: torch.Tensor) -> torch.Tensor:
    """(S, H, *batch, D) -> (S, H, B, D) with B = prod(batch) (>= 1)."""
    return x.reshape(x.shape[0], x.shape[1], -1, x.shape[-1])


def _merge_partials(a, b):
    """Exact combine of flash statistics over disjoint key sets (``m``,
    ``l``: (H, B, Sq); ``acc``: (Sq, H, B, D))."""
    m1, l1, acc1 = a
    m2, l2, acc2 = b
    m = torch.maximum(m1, m2)
    c1 = torch.exp(m1 - m)
    c2 = torch.exp(m2 - m)
    return (m, l1 * c1 + l2 * c2,
            acc1 * c1.movedim(-1, 0)[..., None]
            + acc2 * c2.movedim(-1, 0)[..., None])


def dense_attention(q, k, v, *, causal: bool = False, q_offset: int = 0,
                    kv_offset: int = 0):
    """Reference softmax attention on raw ``(S, H, *batch, D)`` tensors —
    materializes the full score matrix; the golden model of the other
    schemes.  Causal masking is start-aligned by global position: row
    ``i`` sees key ``j`` iff ``q_offset + i >= kv_offset + j``."""
    out_shape, out_dtype = q.shape, q.dtype
    sdt = _score_dtype(torch.promote_types(q.dtype, k.dtype))
    qf, kf, vf = _fold(q), _fold(k), _fold(v)
    s = torch.einsum("snd,tnd->nst", qf.to(sdt), kf.to(sdt))
    s = s / math.sqrt(q.shape[-1])
    if causal:
        rows = q_offset + torch.arange(q.shape[0], device=q.device)
        cols = kv_offset + torch.arange(k.shape[0], device=q.device)
        s = torch.where(rows[:, None] >= cols[None, :], s, _neg_value(sdt))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("nst,tnd->snd", p, vf.to(p.dtype))
    return out.to(out_dtype).reshape(out_shape)


class _FlashKernel(torch.autograd.Function):
    """K2 forward (``return_stats``) with K3 + K4 as its backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, kv_offset):
        out, (m, l) = flash.flash_attention_fwd(
            q, k, v, causal=causal, q_offset=q_offset, kv_offset=kv_offset,
            return_stats=True)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.mask = (causal, q_offset, kv_offset)
        return out

    @staticmethod
    def backward(ctx, g):
        causal, q_offset, kv_offset = ctx.mask
        dq, dk, dv = flash.flash_attention_bwd(
            *ctx.saved_tensors[:4], g, *ctx.saved_tensors[4:], causal=causal,
            q_offset=q_offset, kv_offset=kv_offset)
        return dq, dk, dv, None, None, None


def _use_kernel(q, k, v, impl: str) -> bool:
    """Whether the kernels run: wherever ``flash.supported()`` takes the
    head dim and the three dtypes, unless ``impl="plain"``."""
    ok = flash.supported(q.shape[-1], q.dtype, k.dtype, v.dtype)
    if impl == "kernel" and not ok:
        raise ValueError(
            "impl='kernel' but flash.supported() rejects this case (a dtype "
            "other than float32 and bfloat16, or a head dim that is not a "
            "multiple of 8 up to 1024)")
    return impl != "plain" and ok


def flash_attention(q, k, v, *, causal: bool = False,
                    chunk: Optional[int] = None, q_offset: int = 0,
                    kv_offset: int = 0, impl: str = "auto"):
    """Blockwise softmax attention on raw ``(S, H, *batch, D)`` tensors;
    the ``Sq x Skv`` score matrix never exists.  ``impl`` as in the
    module docstring; ``chunk`` (k/v rows per step) applies to
    ``"plain"``."""
    _check_impl(impl)
    if _use_kernel(q, k, v, impl):
        return _FlashKernel.apply(q, k, v, causal, q_offset, kv_offset)
    _, l, acc = flash.stream_stats(
        _fold(q), _fold(k), _fold(v), causal=causal,
        q_offset=q_offset, kv_offset=kv_offset, chunk=chunk,
        score_dtype=_score_dtype(q.dtype))
    return flash.normalize(l, acc, q.dtype).reshape(q.shape)


# ---------------------------------------------------------------------------
# Ulysses (all-to-all head/sequence reshard)
# ---------------------------------------------------------------------------

def ulysses_attention(q: PencilArray, k: PencilArray, v: PencilArray, *,
                      causal: bool = False, chunk: Optional[int] = None,
                      impl: str = "auto") -> PencilArray:
    """Sequence-parallel attention via the all-to-all head/sequence
    reshard (DeepSpeed-Ulysses), as two transposes.  q/k/v: PencilArrays
    on a ``(S, H)`` pencil decomposed along S, ``extra_dims=(*batch,
    D)``; ``H`` need not divide the rank count (the transpose pads and
    the padded head slots are discarded).  Returns the output on the same
    pencil; differentiable through both hops."""
    _check_impl(impl)
    pen_seq = _check_qkv(q, k, v)
    if pen_seq.decomposition != (0,):
        raise ValueError("ulysses: q/k/v must be sequence-decomposed "
                         "(decomposition == (0,))")
    pen_heads = pen_seq.replace(decomp_dims=(1,))
    # ONE exchange for all three: stacked on a new trailing extra dim, in
    # the promoted dtype (the JAX package's result_type)
    dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
    qkv = PencilArray.stack([x.astype(dt) for x in (q, k, v)])
    blk = transpose(qkv, pen_heads).data     # (S, H/P, *batch, D, 3)
    out = flash_attention(blk[..., 0], blk[..., 1], blk[..., 2],
                          causal=causal, chunk=chunk, impl=impl)
    return transpose(PencilArray(pen_heads, out, q.extra_dims), pen_seq)


# ---------------------------------------------------------------------------
# ring attention, naive and zigzag placements
# ---------------------------------------------------------------------------

def zigzag_indices(S: int, P: int) -> np.ndarray:
    """Global sequence permutation of the zigzag placement: with ``2P``
    blocks of ``S/(2P)``, rank ``i`` holds blocks ``(i, 2P-1-i)``."""
    if S % (2 * P):
        raise ValueError(f"zigzag needs S ({S}) divisible by 2P ({2 * P})")
    b = S // (2 * P)
    order = [blk for i in range(P) for blk in (i, 2 * P - 1 - i)]
    return np.concatenate([np.arange(blk * b, (blk + 1) * b)
                           for blk in order])


def _half_blocks(S: int, P: int, zigzag: bool):
    """Global half-block ids (``2P`` blocks of ``S/(2P)`` rows) per rank,
    in local order: contiguous placement or zigzag placement."""
    if zigzag:
        return [(i, 2 * P - 1 - i) for i in range(P)]
    return [(2 * i, 2 * i + 1) for i in range(P)]


def _relayout(x: PencilArray, to_zz: bool) -> PencilArray:
    """Move half-blocks between the contiguous and the zigzag placement:
    one ``all_to_all_single`` with split sizes, pure data movement."""
    pen = x.pencil
    if not pen.permutation.is_identity() or pen.decomposition != (0,):
        raise ValueError("zigzag layout helpers expect identity-permuted "
                         "sequence-decomposed (S, H) pencils")
    topo = pen.topology
    P = topo.dims[0]
    S = pen.size_global()[0]
    if S % (2 * P):
        raise ValueError(f"zigzag needs S ({S}) divisible by 2P ({2 * P})")
    if P == 1:
        return x
    b = S // (2 * P)
    have = _half_blocks(S, P, not to_zz)
    want = _half_blocks(S, P, to_zz)
    owner = {blk: r for r, blks in enumerate(have) for blk in blks}
    dest = {blk: r for r, blks in enumerate(want) for blk in blks}
    me = topo.rank_local
    rows = x.data.contiguous().reshape(x.data.shape[0], -1).view(torch.uint8)
    # send my half-blocks ordered by destination, then block id
    sends = sorted((dest[blk], blk, h) for h, blk in enumerate(have[me]))
    send = torch.cat([rows[h * b:(h + 1) * b] for _, _, h in sends])
    in_splits = [b * sum(1 for s in sends if s[0] == r) for r in range(P)]
    # they arrive ordered by source rank, then by the sender's block order
    arrivals = sorted((owner[blk], blk) for blk in want[me])
    out_splits = [b * sum(1 for a in arrivals if a[0] == r)
                  for r in range(P)]
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, out_splits, in_splits,
                           group=topo.subcomm(0))
    got = {blk: recv[i * b:(i + 1) * b] for i, (_, blk) in
           enumerate(arrivals)}
    data = torch.cat([got[blk] for blk in want[me]])
    data = data.view(x.dtype).reshape(x.data.shape)
    return PencilArray(pen, data, x.extra_dims)


def to_zigzag(x: PencilArray) -> PencilArray:
    """Reshard a sequence-decomposed array into zigzag placement.  Keep
    q/k/v there in steady state and convert only at the boundaries."""
    return _relayout(x, True)


def from_zigzag(x: PencilArray) -> PencilArray:
    """Inverse of :func:`to_zigzag`."""
    return _relayout(x, False)


def _ops(use_kernel: bool):
    """The per-block forward and backward of a ring schedule."""
    if use_kernel:
        return flash.flash_attention_fwd, flash.flash_attention_bwd_partials
    return (flash.flash_attention_fwd_plain,
            flash.flash_attention_bwd_partials_plain)


def _resid(m, l, g32, out32):
    """Global residuals of one q block: ``L`` and ``D``, (H, B, Sq)."""
    sq = m.shape[-1]
    L, D = flash.residuals(out32, g32, m.reshape(-1, sq), l.reshape(-1, sq))
    return L.reshape(m.shape), D.reshape(m.shape)


class _RingFlash(torch.autograd.Function):
    """Naive-placement ring: P partials rounds merged, then the ring
    backward against the global logsumexp with a rotating dk/dv
    accumulator (the JAX package's ``_ring_flash_pallas``)."""

    @staticmethod
    def forward(ctx, qb, kb, vb, topo: Topology, causal: bool,
                use_kernel: bool):
        fwd, _ = _ops(use_kernel)
        P = topo.dims[0]
        me = topo.coords_local[0]
        s_blk = qb.shape[0]
        carry = None
        cur_k, cur_v = kb, vb
        for r in range(P):
            part = fwd(qb, cur_k, cur_v, causal=causal,
                       q_offset=me * s_blk,
                       kv_offset=((me - r) % P) * s_blk, partials=True)
            carry = part if carry is None else _merge_partials(carry, part)
            if r + 1 < P:
                cur_k, cur_v = ring_shift([cur_k, cur_v], topo)
        m, l, acc = carry
        out32 = flash.normalize(l, acc, m.dtype)
        ctx.save_for_backward(qb, kb, vb, out32, m, l)
        ctx.args = (topo, causal, use_kernel)
        return out32.to(qb.dtype)

    @staticmethod
    def backward(ctx, g):
        qb, kb, vb, out32, m, l = ctx.saved_tensors
        topo, causal, use_kernel = ctx.args
        _, bwd = _ops(use_kernel)
        P = topo.dims[0]
        me = topo.coords_local[0]
        s_blk = qb.shape[0]
        g32 = g.to(out32.dtype)
        L, D = _resid(m, l, g32, out32)
        dq = torch.zeros(qb.shape, dtype=out32.dtype, device=qb.device)
        dk = torch.zeros(kb.shape, dtype=out32.dtype, device=qb.device)
        dv = torch.zeros_like(dk)
        cur_k, cur_v = kb, vb
        for r in range(P):
            # the cotangent in its own dtype (the output's): the per-block
            # backward widens it exactly, and a bf16 ring keeps K3/K4 on
            # their bf16 (wgmma) instance
            dq_r, dk_r, dv_r = bwd(qb, cur_k, cur_v, g, L, D,
                                   causal=causal, q_offset=me * s_blk,
                                   kv_offset=((me - r) % P) * s_blk)
            dq += dq_r
            dk += dk_r
            dv += dv_r
            # dk/dv shift every round (P shifts in all): each block's
            # gradient, added to once on every rank, ends on its home rank
            if r + 1 < P:
                cur_k, cur_v, dk, dv = ring_shift([cur_k, cur_v, dk, dv],
                                                  topo)
            else:
                dk, dv = ring_shift([dk, dv], topo)
        return (dq.to(qb.dtype), dk.to(kb.dtype), dv.to(vb.dtype), None,
                None, None)


def _zigzag_pairs(me: int, r: int, P: int, b: int):
    """The blocks rank ``me`` of a zigzag ring computes in round ``r``, as
    ``(q half, k half, q_offset, kv_offset)`` with halves 0 = lo, 1 = hi
    of the own q block and of the k/v block held this round, which came
    from sender ``j = (me - r) mod P``.  Round 0 does the three needed
    pairs of the own blocks; every later round two: ``hi x klo`` always,
    then ``lo x klo`` when the sender's lo block is in the past
    (``me >= r``), else ``hi x khi``."""
    j = (me - r) % P
    lo, hi = me * b, (2 * P - 1 - me) * b
    jlo, jhi = j * b, (2 * P - 1 - j) * b
    if r == 0:
        return [(0, 0, lo, jlo), (1, 0, hi, jlo), (1, 1, hi, jhi)]
    if me >= r:   # sender j = me - r
        return [(1, 0, hi, jlo), (0, 0, lo, jlo)]
    return [(1, 0, hi, jlo), (1, 1, hi, jhi)]   # sender j = me - r + P


def _half(x: torch.Tensor, h: int, b: int) -> torch.Tensor:
    return x[h * b:(h + 1) * b]


class _ZigzagFlash(torch.autograd.Function):
    """Zigzag-placement causal ring (the JAX package's
    ``_zigzag_flash_pallas``).  Rank ``i`` holds q blocks ``lo = i`` and
    ``hi = 2P-1-i`` and runs the pairs of :func:`_zigzag_pairs`."""

    @staticmethod
    def forward(ctx, qb, kb, vb, topo: Topology, use_kernel: bool):
        fwd, _ = _ops(use_kernel)
        P = topo.dims[0]
        me = topo.coords_local[0]
        b = qb.shape[0] // 2
        stats = [None, None]   # (m, l, acc) of the lo and hi q halves
        rk, rv = kb, vb
        for r in range(P):
            if r:
                rk, rv = ring_shift([rk, rv], topo)
            for qh, kh, qo, ko in _zigzag_pairs(me, r, P, b):
                part = fwd(_half(qb, qh, b), _half(rk, kh, b),
                           _half(rv, kh, b), causal=True, q_offset=qo,
                           kv_offset=ko, partials=True)
                stats[qh] = (part if stats[qh] is None
                             else _merge_partials(stats[qh], part))
        (m_lo, l_lo, acc_lo), (m_hi, l_hi, acc_hi) = stats
        out32 = torch.cat([flash.normalize(l_lo, acc_lo, m_lo.dtype),
                           flash.normalize(l_hi, acc_hi, m_hi.dtype)])
        ctx.save_for_backward(qb, kb, vb, out32, m_lo, l_lo, m_hi, l_hi)
        ctx.args = (topo, use_kernel)
        return out32.to(qb.dtype)

    @staticmethod
    def backward(ctx, g):
        qb, kb, vb, out32, m_lo, l_lo, m_hi, l_hi = ctx.saved_tensors
        topo, use_kernel = ctx.args
        _, bwd = _ops(use_kernel)
        P = topo.dims[0]
        me = topo.coords_local[0]
        b = qb.shape[0] // 2
        g32 = g.to(out32.dtype)
        resid = [_resid(m_lo, l_lo, g32[:b], out32[:b]),
                 _resid(m_hi, l_hi, g32[b:], out32[b:])]
        dq = [None, None]
        dk = torch.zeros(kb.shape, dtype=out32.dtype, device=kb.device)
        dv = torch.zeros_like(dk)
        rk, rv = kb, vb
        for r in range(P):
            if r:
                rk, rv, dk, dv = ring_shift([rk, rv, dk, dv], topo)
            for qh, kh, qo, ko in _zigzag_pairs(me, r, P, b):
                dq_p, dk_p, dv_p = bwd(
                    _half(qb, qh, b), _half(rk, kh, b), _half(rv, kh, b),
                    _half(g, qh, b), *resid[qh], causal=True, q_offset=qo,
                    kv_offset=ko)   # g in its own dtype, as in _RingFlash
                dq[qh] = dq_p if dq[qh] is None else dq[qh] + dq_p
                _half(dk, kh, b).add_(dk_p)
                _half(dv, kh, b).add_(dv_p)
        # the last of P shifts brings every block's gradient home
        dk, dv = ring_shift([dk, dv], topo)
        return (torch.cat(dq).to(qb.dtype), dk.to(kb.dtype), dv.to(vb.dtype),
                None, None)


def ring_attention(q: PencilArray, k: PencilArray, v: PencilArray, *,
                   causal: bool = False, zigzag: bool = False,
                   impl: str = "auto") -> PencilArray:
    """Blockwise ring attention: k/v blocks rotate around the ring while
    flash partials merge exactly.  q/k/v as in :func:`ulysses_attention`;
    any ``H``.  ``zigzag=True`` (needs ``causal=True``) takes and returns
    arrays in zigzag placement (:func:`to_zigzag`).  Differentiable: the
    backward is a second ring pass."""
    _check_impl(impl)
    pen_seq = _check_qkv(q, k, v)
    if pen_seq.decomposition != (0,):
        raise ValueError("ring: q/k/v must be sequence-decomposed")
    if zigzag and not causal:
        raise ValueError("zigzag placement only changes the causal "
                         "schedule; use zigzag=True with causal=True")
    topo = pen_seq.topology
    P = topo.dims[0]
    S = pen_seq.size_global()[0]
    if zigzag and S % (2 * P):
        raise ValueError("zigzag needs S divisible by 2P")
    use_zigzag = causal and zigzag and P > 1
    use_kernel = _use_kernel(q.data, k.data, v.data, impl)
    qb, kb, vb = (_fold_batch(x.data) for x in (q, k, v))
    if use_zigzag:
        out = _ZigzagFlash.apply(qb, kb, vb, topo, use_kernel)
    else:
        out = _RingFlash.apply(qb, kb, vb, topo, causal, use_kernel)
    return PencilArray(pen_seq, out.reshape(q.data.shape), q.extra_dims)
