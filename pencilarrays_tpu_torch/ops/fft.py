"""Distributed N-D FFT over pencil decompositions — the PencilFFTs layer.

PyTorch counterpart of the JAX package's ``ops/fft.py``.  The plan is the
same static schedule, built by the same code: the extent-aware stage chain
(:func:`_build_chain`), one pencil permutation per stage placing the
stage's transform dim last in memory (``permute=True``), and at each stage
ONE batched local transform over every pending dim that is local there.
Between stages the transpose engine moves the data
(``parallel/transpositions.py``) by the plan's ``method`` (``AllToAll``,
``Ring``, ``Pipelined`` or ``Auto``).  Each rank transforms its own block
with ``torch.fft`` (cuFFT on the card): a library call for what the JAX
package leaves to XLA.  The ``dct``/``dst`` kinds (DCT-II and DST-II,
ortho in every normalization mode) are built from ``torch.fft`` (Makhoul's
even/odd reordering and a twiddle), as the JAX package leaves them to
``jax.scipy.fft``.

One layout step is the port's own.  A pencil block keeps its extra dims
(vector components, a ``batch=B`` plan's samples) innermost, so handed to
``torch.fft`` as it is, each transform would be a strided batch entry.  A
stage with extra dims instead moves them outermost with kernel K1 before
the transform and back after it (two K1 launches per stage), so cuFFT sees
one contiguous signal per batch entry.  ``chip_smoke.py`` (``fft_strided``)
times this against one strided-batch call on the card; see ``PERF.md``.

``pipeline=K`` fuses each eligible hop with the stage after it
(:func:`_fused_hop`): the exchange in ``K`` chunks along a dim neither the
exchange nor the stage's transforms touch, chunk ``k + 1``'s exchange in
flight (NCCL's stream) while chunk ``k`` is unpacked and transformed (the
compute stream).  The step list is the JAX package's, kind for kind.

Normalization is applied as the JAX package applies it: bare transforms
("backward" semantics) followed by a multiply with a Python float, never
through ``torch.fft``'s ``norm=``.

Plan options as in the JAX package: ``wire_dtype=`` puts every hop's
payload on a reduced-precision wire (``parallel/wire.py``; the transforms
stay in full precision), ``decomposition="slab" | "pencil" | "auto"``
re-factorizes the topology's ranks into the 1-D or 2-D grid the cost model
scores cheapest, and ``hbm_limit=`` time-slices every hop whose modeled
peak exceeds the limit (or raises ``HbmBoundError`` naming it).
``compile()`` captures each direction's chain as a CUDA graph on the
card (an eager chain on the CPU), and ``forward_async``/``backward_async``
run a call on an ``engine.Engine``.

Every plan is differentiable: a hop through ``transpositions._Hop`` (its
backward is the inverse hop), a fused hop through :class:`_FusedHop`
(the mirrored program), and a stage's extra-dim moves through K1's
autograd function, each backward launching K1 on the card.
"""

from __future__ import annotations

import json
import math
import os
import threading
import weakref
from itertools import permutations as _iperms
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs.tracing import span
from ..parallel import collectives as _collectives
from ..parallel import wire as _wire
from ..parallel.arrays import PencilArray, as_torch_dtype
from ..parallel.pencil import LogicalOrder, MemoryOrder, Pencil
from ..parallel.topology import Topology
from ..parallel.transpositions import (
    AllToAll,
    AbstractTransposeMethod,
    Auto,
    Pipelined,
    Ring,
    _chunk_bounds,
    _dtype_name,
    _Exchange,
    _exchange_operand_extents,
    _hop_label,
    _method_label,
    _method_wire,
    _no_wired_grad,
    _obs_record_hop,
    _pipeline_chunk_axis,
    _probe_group,
    _run_pipeline,
    assert_compatible,
    resolve_method,
    strip_wire,
    transpose,
    transpose_cost,
    with_wire,
)
from ..utils.permutations import Permutation
from . import permute as k1

__all__ = ["PencilFFTPlan", "CompiledPlan"]

_KINDS = ("fft", "rfft", "dct", "dst", "none")


def _makhoul_order(n: int, device) -> torch.Tensor:
    """Even elements in order, then odd ones reversed (Makhoul 1980)."""
    order = list(range(0, n, 2)) + list(range(n - 1 - n % 2, 0, -2))
    return torch.tensor(order, dtype=torch.int64, device=device)


def _dct_twiddle(n: int, like: torch.Tensor) -> torch.Tensor:
    """``exp(-i pi k / 2n)`` times the ortho scale of DCT-II coefficient
    ``k`` doubled (``sqrt(1/n)`` for ``k = 0``, else ``sqrt(2/n)``)."""
    k = torch.arange(n, dtype=torch.float64)
    scale = torch.full((n,), math.sqrt(2.0 / n), dtype=torch.float64)
    scale[0] = math.sqrt(1.0 / n)
    w = torch.polar(scale, -0.5 * math.pi / n * k)
    return w.to(device=like.device, dtype=like.dtype)


def _dct(blk: torch.Tensor, dim: int) -> torch.Tensor:
    """Orthonormal DCT-II along ``dim``: one real FFT of the
    Makhoul-reordered signal, ``X_k = Re(t_k V_k)`` for ``k <= n/2`` and
    ``X_{n-j} = -Im(t_j V_j)`` above (``t`` from :func:`_dct_twiddle`)."""
    n = blk.shape[dim]
    x = blk.movedim(dim, -1)
    V = torch.fft.rfft(x.index_select(-1, _makhoul_order(n, x.device)))
    h = V.shape[-1]
    Z = V * _dct_twiddle(n, V)[:h]
    return torch.cat([Z.real, -Z.imag[..., 1:n - h + 1].flip(-1)],
                     dim=-1).movedim(-1, dim)


def _idct(blk: torch.Tensor, dim: int) -> torch.Tensor:
    """Inverse of :func:`_dct` (DCT-III, ortho): with ``Y = X / |t|``,
    ``V_k = (Y_k - i Y_{n-k}) conj(t_k / |t_k|)`` for ``k <= n/2``, one
    inverse real FFT and the Makhoul order undone."""
    n = blk.shape[dim]
    y = blk.movedim(dim, -1)
    h = n // 2 + 1
    t = _dct_twiddle(n, torch.empty(0, dtype=torch.promote_types(
        y.dtype, torch.complex64), device=y.device))
    Y = y / t.abs().to(y.dtype)
    Yrev = torch.cat([torch.zeros_like(Y[..., :1]),
                      Y[..., n - h + 1:].flip(-1)], dim=-1)
    V = torch.complex(Y[..., :h], -Yrev) * (t[:h] / t[:h].abs()).conj()
    v = torch.fft.irfft(V, n=n)
    inv = torch.argsort(_makhoul_order(n, v.device))
    return v.index_select(-1, inv).movedim(-1, dim)


def _alt_signs(blk: torch.Tensor, dim: int) -> torch.Tensor:
    """``(-1)^j`` along ``dim``, broadcast-shaped."""
    shape = [1] * blk.dim()
    shape[dim] = blk.shape[dim]
    j = torch.arange(blk.shape[dim], device=blk.device)
    return (1 - 2 * (j % 2)).to(blk.dtype).reshape(shape)


def _dst(blk: torch.Tensor, dim: int) -> torch.Tensor:
    # DST-II(x) = reverse(DCT-II(x * (-1)^j)), ortho (the JAX package's)
    return torch.flip(_dct(blk * _alt_signs(blk, dim), dim), (dim,))


def _idst(blk: torch.Tensor, dim: int) -> torch.Tensor:
    # IDST-II(y) = (-1)^j * IDCT-II(reverse(y))
    out = _idct(torch.flip(blk, (dim,)), dim)
    return out * _alt_signs(out, dim)


def _per_sample(transform, moved: torch.Tensor, E: int) -> torch.Tensor:
    """``transform`` of a CPU block whose ``E`` extra dims lead, one
    sample at a time, each written into its slot of one output.  By
    contract a CPU stage is per sample: pocketfft groups a transform's
    lines into SIMD vectors by their count, and a vector line rounds
    apart from a scalar one, so only a sample transformed as a call of
    its own keeps a batch bit-identical to its samples' calls (the serve
    layer's coalescing contract)."""
    flat = moved.reshape((-1,) + tuple(moved.shape[E:]))
    first = transform(flat[0], 0)
    res = torch.empty((flat.shape[0],) + tuple(first.shape),
                      dtype=first.dtype)
    res[0].copy_(first)
    for i in range(1, flat.shape[0]):
        res[i].copy_(transform(flat[i], 0))
    return res.reshape(tuple(moved.shape[:E]) + tuple(first.shape))


def _stage_op(ops: tuple, inverse: bool, pre_complex: bool, norm: str,
              nspace: int, move=k1.permute):
    """Per-block batched local transform of one schedule step:
    ``op(blk, out=None)``, the result written into the view ``out`` when
    one is given.

    ``ops`` is a tuple of ``(kind, mem_axis, n_logical)`` — every transform
    applied at this stage, along axes local in the stage pencil.  Blocks
    carry ``nspace`` spatial dims followed by their extra dims, which
    ``move`` (K1, differentiable on the card: ``permute._Permute``) takes
    outermost and back around the transform.  R2R kinds run before the
    Fourier kinds forward and after them inverse, ortho in every
    normalization mode."""
    r2r = tuple(op for op in ops if op[0] in ("dct", "dst"))
    four = tuple(op for op in ops if op[0] in ("fft", "rfft"))
    rf = tuple(op for op in four if op[0] == "rfft")
    cax = tuple(ax for k, ax, n in four if k == "fft")
    P_stage = 1.0
    for k, ax, n in four:
        P_stage *= float(n)
    fwd_scale = {"backward": 1.0, "none": 1.0, "forward": 1.0 / P_stage,
                 "ortho": P_stage ** -0.5}[norm]
    inv_scale = {"backward": 1.0, "none": P_stage, "forward": P_stage,
                 "ortho": P_stage ** 0.5}[norm]

    def transform(blk, shift):
        # shift: index of the first spatial dim (extra dims moved in front)
        ca = tuple(ax + shift for ax in cax)
        if not inverse:
            for k, ax, n in r2r:
                blk = (_dct if k == "dct" else _dst)(blk, ax + shift)
            if rf:
                blk = torch.fft.rfftn(blk, dim=ca + (rf[0][1] + shift,))
            elif cax:
                blk = torch.fft.fftn(blk, dim=ca)
            if four and fwd_scale != 1.0:
                blk = blk * fwd_scale
            return blk
        if rf:
            _, ax, n = rf[0]
            s = tuple(m for k, a, m in four if k == "fft") + (n,)
            blk = torch.fft.irfftn(blk, s=s, dim=ca + (ax + shift,))
        elif cax:
            blk = torch.fft.ifftn(blk, dim=ca)
        if four and inv_scale != 1.0:
            blk = blk * inv_scale
        if not pre_complex and blk.is_complex():
            # forward promoted real->complex here; imag is numerically zero
            blk = blk.real
        for k, ax, n in reversed(r2r):
            blk = (_idct if k == "dct" else _idst)(blk, ax + shift)
        return blk

    def op(blk, out=None):
        E = blk.dim() - nspace
        if not (four or r2r):
            res = blk
        elif E == 0:
            res = transform(blk, 0)
        else:
            front = tuple(range(nspace, nspace + E)) + tuple(range(nspace))
            back = tuple(range(E, E + nspace)) + tuple(range(E))
            moved = move(blk, front)
            if moved.device.type == "cpu":
                res = _per_sample(transform, moved, E)
            else:
                res = transform(moved, E)
            # torch.fft lays a transform over some of the dims out batch
            # dims first (a DCT x FFT x FFT stage); K1 moved that layout at
            # a tenth of its bound (20.0 against 1.9 ms, 512^3 x 3 c64 on
            # an H100, PERF.md), so copy it first and let K1 take its
            # narrow instance
            return move(res.contiguous(), back, out=out)
        if out is None:
            return res
        return out.copy_(res)

    return op


def _stage_dtype(ops: tuple, inverse: bool, pre_complex: bool,
                 dtype: torch.dtype) -> torch.dtype:
    """The dtype a stage's transform gives a block of ``dtype``."""
    if not any(op[0] in ("fft", "rfft") for op in ops):
        return dtype
    if not inverse:
        return _complex_of(dtype)
    return dtype if pre_complex else torch.empty((), dtype=dtype).real.dtype


def _stage_vjp(ops: tuple, inverse: bool, pre_complex: bool, norm: str,
               nspace: int, shape, dtype):
    """``g -> J^T g`` of a stage's transform on blocks of ``shape`` and
    ``dtype`` — the transform is linear, so its vector-Jacobian product
    needs no saved input (autograd of ``torch.fft`` on zeros)."""
    op = _stage_op(ops, inverse, pre_complex, norm, nspace)

    def vjp(g):
        with torch.enable_grad():
            z = torch.zeros(shape, dtype=dtype, device=g.device,
                            requires_grad=True)
            (gz,) = torch.autograd.grad(op(z), z, g)
        return gz

    return vjp


class _FusedProgram:
    """One fused pipelined hop: the exchange ``src -> tgt`` in chunks
    along logical dim ``chunk_dim`` with the stage's transform per chunk
    (the JAX package's ``_fused_hop_fn``).  Forward, per chunk: pack ->
    exchange -> unpack -> transform, the transform's output written into
    its slice of the post-stage block; inverse (the mirrored program):
    inverse transform of the chunk's slice -> pack -> reverse exchange ->
    unpack into the chunk's slice of the source block.  Either way chunk
    ``k + 1``'s exchange is issued before chunk ``k`` is consumed
    (``_run_pipeline``)."""

    def __init__(self, src, tgt, post, extra_ndims, ops, inverse,
                 pre_complex, norm, base, chunk_dim, bounds):
        self.src, self.tgt, self.post = src, tgt, post
        self.ops, self.inverse, self.pre_complex = ops, inverse, pre_complex
        self.norm, self.bounds = norm, tuple(bounds)
        self.nspace = src.ndims
        self.fwd = _Exchange(src, tgt, extra_ndims, base)
        self.rev = _Exchange(tgt, src, extra_ndims, base)
        self.mc_src = self.fwd.fwd_in.index(chunk_dim)
        self.mc_tgt = self.fwd.fwd_out.index(chunk_dim)   # post's too

    def _block(self, pen, x):
        return pen.padded_size_local(MemoryOrder) + tuple(
            x.shape[self.nspace:])

    def _chunk(self, shape, dim, k):
        s0, s1 = self.bounds[k]
        shape = list(shape)
        shape[dim] = s1 - s0
        return tuple(shape)

    def _narrow(self, t, dim, k):
        s0, s1 = self.bounds[k]
        return t.narrow(dim, s0, s1 - s0)

    def _exchange_then(self, x, post_fn, out_shape, dtype):
        """src block -> chunks through the exchange -> ``post_fn(k, y,
        dst)`` writes chunk ``k`` into its slice of the output."""
        out = x.new_empty(out_shape, dtype=dtype)

        def produce(k):
            return self.fwd.pack(self._narrow(x, self.mc_src, k))

        def consume(k, h, recv):
            post_fn(k, self.fwd.unpack(recv, h),
                    self._narrow(out, self.mc_tgt, k))

        _run_pipeline(len(self.bounds), produce, self.fwd, consume)
        return out

    def _then_exchange(self, x, pre_fn, out_shape, dtype):
        """post block -> ``pre_fn(k, chunk)`` -> chunks through the reverse
        exchange into their slices of the source block."""
        out = x.new_empty(out_shape, dtype=dtype)

        def produce(k):
            return self.rev.pack(pre_fn(k, self._narrow(x, self.mc_tgt, k)))

        def consume(k, h, recv):
            self.rev.unpack(recv, h, out=self._narrow(out, self.mc_src, k))

        _run_pipeline(len(self.bounds), produce, self.rev, consume)
        return out

    def run(self, x: torch.Tensor) -> torch.Tensor:
        transform = _stage_op(self.ops, self.inverse, self.pre_complex,
                              self.norm, self.nspace)

        def op(blk, out=None):
            with span("stage_compute"):
                return transform(blk, out=out)

        if not self.inverse:
            return self._exchange_then(
                x, lambda k, y, dst: op(y, out=dst),
                self._block(self.post, x),
                _stage_dtype(self.ops, False, self.pre_complex, x.dtype))
        dtype = _stage_dtype(self.ops, True, self.pre_complex, x.dtype)
        return self._then_exchange(x, lambda k, blk: op(blk),
                                   self._block(self.src, x), dtype)

    def adjoint(self, g: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """``J^T g``: the mirrored program with each chunk's transform
        replaced by its vector-Jacobian product (``dtype``: the forward
        input's)."""
        args = (self.ops, self.inverse, self.pre_complex, self.norm,
                self.nspace)
        if not self.inverse:
            tgt_block = self._block(self.tgt, g)
            return self._then_exchange(
                g, lambda k, blk: _stage_vjp(*args, self._chunk(
                    tgt_block, self.mc_tgt, k), dtype)(blk),
                self._block(self.src, g), dtype)
        post_block = self._block(self.post, g)
        return self._exchange_then(
            g, lambda k, y, dst: dst.copy_(_stage_vjp(*args, self._chunk(
                post_block, self.mc_tgt, k), dtype)(y)),
            post_block, dtype)


class _FusedHop(torch.autograd.Function):
    """A fused hop whose backward is the mirrored program on the
    cotangent (:meth:`_FusedProgram.adjoint`)."""

    @staticmethod
    def forward(ctx, data, program):
        ctx.program, ctx.dtype = program, data.dtype
        return program.run(data)

    @staticmethod
    def backward(ctx, grad):
        return ctx.program.adjoint(grad, ctx.dtype), None


def _fused_hop(data: torch.Tensor, src: Pencil, tgt: Pencil, post: Pencil,
               extra_ndims: int, ops: tuple, inverse: bool,
               pre_complex: bool, norm: str,
               base: AbstractTransposeMethod, chunk_dim: int,
               bounds: tuple) -> torch.Tensor:
    """One fused pipelined hop ``src -> tgt`` + the stage ``tgt -> post``
    (or, ``inverse``, its mirror from ``post`` back to ``src``) on this
    rank's block: :class:`_FusedProgram`, differentiable through
    :class:`_FusedHop`.  Values equal the serialized hop followed by the
    stage: the data movement bit for bit, the transform up to cuFFT's
    choice of plan for another batch count."""
    program = _FusedProgram(src, tgt, post, extra_ndims, ops, inverse,
                            pre_complex, norm, base, chunk_dim, bounds)
    if data.requires_grad and torch.is_grad_enabled():
        _no_wired_grad(base)
        return _FusedHop.apply(data, program)
    return program.run(data)


def _fuse_spec(t_step: tuple, f_step: tuple, K: int, method,
               trivial_axis: bool = False):
    """The fused ``("ft", src, tgt, hop_dtype, post, ops, pre_complex,
    base, chunk_dim, bounds)`` step of a hop and the stage after it, or
    ``None`` where the pair stays serialized (the JAX package's
    ``_try_fuse_hop``): a local permute, a size-1 axis (unless
    ``trivial_axis``, which lets ``chip_smoke.py`` run a fused hop on one
    card), or no dim outside the exchange pair and the stage's transform
    dims to chunk."""
    _, src, tgt, hop_dtype = t_step
    _, pre, post, ops, pre_complex = f_step
    R = assert_compatible(src, tgt)
    if R is None or (src.topology.dims[R] == 1 and not trivial_axis):
        return None
    base = resolve_method(src, tgt, (), hop_dtype, method)
    if isinstance(base, Pipelined):
        base = base.base             # the fused hop owns the chunking
    a, b = src.decomposition[R], tgt.decomposition[R]
    N = src.ndims
    mem_ids = tgt.permutation.apply(tuple(range(N)))
    transform_dims = tuple(mem_ids[ax] for _, ax, _ in ops)
    ext = _exchange_operand_extents(src, tgt, R)
    c = _pipeline_chunk_axis(ext, a, b, exclude=transform_dims)
    if c is None:
        return None
    bounds = _chunk_bounds(ext[c], K)
    if len(bounds) <= 1:
        return None
    return ("ft", src, tgt, hop_dtype, post, tuple(ops), pre_complex, base,
            c, bounds)


# literature default for pipeline="auto" with no sweep of the port's own
# (arXiv:1804.09536 tables 2-4 land at 2-8 pipeline stages), the JAX
# package's default
_PIPELINE_AUTO_DEFAULT_K = 4


def _pipeline_sweep_verdict(platform: str):
    """The verdict of ``PIPELINE_SWEEP.json`` (repo root) when it was
    captured on ``platform`` (the port's own: ``"torch-cuda"``,
    ``"torch-cpu"``), else ``None``: no sweep of another platform — the
    JAX package's CPU or TPU — routes the port."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "PIPELINE_SWEEP.json")
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or doc.get("platform") != platform:
        return None
    return doc.get("verdict")


def _stage_permutation(ndims: int, d: int, permute: bool):
    """Permutation placing logical dim ``d`` last in memory order."""
    if not permute:
        return None
    others = tuple(i for i in range(ndims) if i != d)
    return Permutation(others + (d,))


def _legacy_chain(N: int, M: int) -> List[Tuple[int, ...]]:
    """The classic x->y->z decomposition chain."""
    out = []
    dec = list(range(N - M, N))
    for d in range(N):
        out.append(tuple(dec))
        if d + 1 < N and (d + 1) in dec:
            dec[dec.index(d + 1)] = d
    return out


def _strand_pad(n: int, P: int) -> Tuple[int, int]:
    """(empty ranks, padding elements) for extent ``n`` ceil-blocked over
    ``P`` ranks."""
    if P <= 1 or n == 0:
        return (0, 0)
    b = -(-n // P)
    return (P - (-(-n // b)), b * P - n)


def _build_chain(topology: Topology, global_shape: Tuple[int, ...],
                 kinds: Tuple[str, ...]) -> List[Tuple[int, ...]]:
    """Extent-aware stage chain, the JAX package's DP verbatim: stage ``d``
    keeps dim ``d`` local (unless its kind is ``none``), consecutive stages
    differ in at most one slot, and the chain minimises (hops, stranded
    ranks, padding elements), ties resolving to the legacy chain."""
    N = len(global_shape)
    M = topology.ndims
    dims = topology.dims
    legacy = _legacy_chain(N, M)
    spectral = tuple(n // 2 + 1 if k == "rfft" else n
                     for n, k in zip(global_shape, kinds))

    def stage_cost(dec: Tuple[int, ...], s: int) -> Tuple[int, int]:
        strands = pad = 0
        for i, p in enumerate(dec):
            n = spectral[p] if p < s else global_shape[p]
            a, b = _strand_pad(n, dims[i])
            strands += a
            pad += b
        return strands, pad

    def states(d: int) -> List[Tuple[int, ...]]:
        pool = [p for p in range(N) if p != d or kinds[d] == "none"]
        cands = [tuple(t) for t in _iperms(pool, M)]
        cands.sort(key=lambda t: t != legacy[d])  # legacy first: tie-break
        return cands

    prev = {st: ((0,) + stage_cost(st, 0), [st]) for st in states(0)}
    for d in range(1, N):
        nxt = {}
        for st in states(d):
            sc = stage_cost(st, d)
            best = None
            for pst, (c, path) in prev.items():
                ndiff = sum(x != y for x, y in zip(pst, st))
                if ndiff > 1:
                    continue
                cand = (c[0] + (1 if ndiff else 0), c[1] + sc[0],
                        c[2] + sc[1])
                if best is None or cand < best[0]:
                    best = (cand, path + [st])
            if best is not None:
                nxt[st] = best
        prev = nxt
    return min(prev.values(), key=lambda v: v[0])[1]


def _complex_of(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.complex64)


def _decomposition_candidates(nprocs: int, N: int, mode: str
                              ) -> List[Tuple[int, ...]]:
    """Topology shapes ``decomposition=`` may pick on ``nprocs`` ranks for
    a rank-``N`` array: the slab ``(P,)`` (``N > 1``) and every ordered
    pencil ``(P1, P2)`` with both factors > 1 (``N > 2``)."""
    cands: List[Tuple[int, ...]] = []
    if mode in ("auto", "slab") and N > 1:
        cands.append((nprocs,))
    if mode in ("auto", "pencil") and N > 2:
        for p1 in range(2, nprocs):
            if nprocs % p1 == 0 and nprocs // p1 >= 2:
                cands.append((p1, nprocs // p1))
    return cands


def _iter_priced_hops(steps: tuple):
    """``(src, dst, hop_dtype, base, k_mult, chunk)`` of every exchange
    step: ``base`` is ``None`` for a plain ``"t"`` hop by the plan's
    method, the hop's own method for a ``"t"`` hop an ``hbm_limit``
    time-sliced, and the AllToAll/Ring base of a fused ``"ft"`` hop, whose
    ``chunk = (chunk_dim, bounds)`` multiplies its count by ``k_mult``."""
    for step in steps:
        if step[0] == "t":
            yield step[1], step[2], step[3], (
                step[4] if len(step) > 4 else None), 1, None
        elif step[0] == "ft":
            (_, src, dst, hop_dtype, _post, _ops, _pc, base,
             c, bounds) = step
            yield src, dst, hop_dtype, base, len(bounds), (c, bounds)


def _schedule_score(plan: "PencilFFTPlan", extra_dims: Tuple[int, ...],
                    latency_bytes: int, drift_hops: dict) -> dict:
    """Bytes-equivalent score of one forward schedule, the route
    planner's currency: ``latency_bytes`` per collective call, the bytes
    scaled by the hop's trusted drift ratio
    (``parallel/routing.py`` ``trusted_drift``), and a wired hop's cast
    toll."""
    from ..parallel.routing import trusted_drift

    score = hops = total_bytes = total_count = 0
    for src, dst, hop_dtype, base, k_mult, chunk in _iter_priced_hops(
            plan._steps):
        m = (resolve_method(src, dst, extra_dims, hop_dtype, plan.method)
             if base is None else base)
        cost = transpose_cost(src, dst, extra_dims, hop_dtype, m,
                              chunk=chunk)
        if not cost:
            continue
        drift = trusted_drift(drift_hops, _hop_label(src, dst, m, hop_dtype))
        count = sum(v["count"] for v in cost.values())
        nbytes = sum(v["bytes"] for v in cost.values())
        score += int(count * latency_bytes + nbytes * drift
                     + _wire.cast_score_bytes(nbytes, hop_dtype,
                                              _method_wire(m)))
        hops += 1
        total_bytes += nbytes
        total_count += count
    return {"score_bytes": score, "hops": hops,
            "predicted_bytes": total_bytes, "collectives": total_count}


_REFACTORED: dict = {}


def _refactored_topology(topology: Topology, dims: Tuple[int, ...]
                         ) -> Topology:
    """``topology``'s ranks as a topology of ``dims`` (itself where the
    dims agree).  Building one is collective over the ranks, which every
    rank does alike (the verdict is a pure function of the
    configuration); one is built per (topology, dims) and kept."""
    if tuple(dims) == topology.dims:
        return topology
    key = (topology, tuple(dims))
    if key not in _REFACTORED:
        _REFACTORED[key] = Topology(dims, device=topology.device,
                                    group=topology.group)
    return _REFACTORED[key]


def _resolve_decomposition(topology: Topology,
                           global_shape: Tuple[int, ...], mode: str,
                           plan_kwargs: dict,
                           extra_dims: Tuple[int, ...]):
    """The cheapest slab or pencil grid over ``topology``'s ranks for
    ``decomposition=``: each candidate's full schedule (a probe plan on a
    topology without process groups, so pricing is not collective) scored
    by :func:`_schedule_score`, drift-corrected like the route planner
    (in a one-process world only, ``routing.trusted_drift_hops``); ties
    go to fewer hops, then the slab, then dims order.  Returns
    ``(topology, verdict)``, the JAX package's verdict dict."""
    import warnings

    from ..parallel.routing import trusted_drift_hops

    N = len(global_shape)
    cands = _decomposition_candidates(len(topology), N, mode)
    if not cands:
        raise ValueError(
            f"decomposition={mode!r}: no admissible topology for "
            f"{len(topology)} device(s) over a rank-{N} array")
    method = plan_kwargs.get("method")
    latency = (method.latency_bytes if isinstance(method, Auto)
               else Auto().latency_bytes)
    drift_hops = trusted_drift_hops()
    scored = []
    for dims in cands:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            probe = PencilFFTPlan(Topology.unconnected(dims, topology.device),
                                  global_shape, _probe=True, **plan_kwargs)
        entry = _schedule_score(probe, extra_dims, latency, drift_hops)
        entry["dims"] = tuple(dims)
        entry["family"] = "slab" if len(dims) == 1 else "pencil"
        scored.append(entry)
    scored.sort(key=lambda c: (c["score_bytes"], c["hops"],
                               len(c["dims"]), c["dims"]))
    win = scored[0]
    verdict = {
        "mode": mode,
        "winner": list(win["dims"]),
        "family": win["family"],
        "extra_dims": list(extra_dims),
        "drift_corrected": bool(drift_hops),
        "candidates": [
            {"dims": list(c["dims"]), "family": c["family"],
             "score_bytes": c["score_bytes"], "hops": c["hops"],
             "predicted_bytes": c["predicted_bytes"],
             "collectives": c["collectives"]}
            for c in scored],
    }
    return _refactored_topology(topology, win["dims"]), verdict


class PencilFFTPlan:
    """Plan for a distributed N-D transform with per-dimension kinds
    (PencilFFTs' ``PencilFFTPlan``).  Arguments as in the JAX package:
    ``transforms`` (or ``real=True`` for ``rfft x fft x ...``, or
    ``transform="dct"``/``"dst"``), ``normalization`` in ``backward |
    ortho | forward | none`` (R2R kinds are ortho in every mode),
    ``batch=B`` for B transforms sharing one schedule (extra dims
    ``(B,)``), ``method`` for every hop (``AllToAll()``, ``Ring()``,
    ``Pipelined(...)`` or ``Auto()``) and ``pipeline=None | K | "auto"``:
    ``K > 1`` fuses each eligible hop with the stage after it into one
    chunked program (:func:`_fused_hop`); ``"auto"`` follows a sweep
    captured on the port's own platform, else ``K = 4``.  Values and
    gradients do not depend on ``method`` or ``pipeline``."""

    def __init__(self, topology: Topology, global_shape: Sequence[int], *,
                 real: bool = False, dtype=None, permute: bool = True,
                 transform="fft", transforms: Sequence[str] = None,
                 method: AbstractTransposeMethod = AllToAll(),
                 normalization: str = "backward", pipeline=None,
                 batch: Optional[int] = None,
                 decomposition: Optional[str] = None, wire_dtype=None,
                 hbm_limit: Optional[int] = None, _probe: bool = False):
        if not isinstance(method, (AllToAll, Ring, Pipelined, Auto)):
            raise TypeError(f"unknown transpose method {method!r}")
        if pipeline is not None and pipeline != "auto" and (
                not isinstance(pipeline, int) or pipeline < 1):
            raise ValueError(
                f"pipeline must be None, a positive int, or 'auto', got "
                f"{pipeline!r}")
        global_shape = tuple(int(n) for n in global_shape)
        N = len(global_shape)
        # -- the wire: the plan's method carries it (with_wire), so pricing
        # and execution see one wire
        self.wire_dtype = _wire.canonical_wire_dtype(wire_dtype)
        method = with_wire(method, self.wire_dtype)
        if self.wire_dtype is None:
            self.wire_dtype = _method_wire(method)
        if batch is not None and (isinstance(batch, bool)
                                  or not isinstance(batch, int) or batch < 1):
            raise ValueError(
                f"batch must be None or a positive int, got {batch!r}")
        self.batch = batch
        self.batch_dims: Tuple[int, ...] = (int(batch),) if batch else ()
        # -- slab or pencil grid over the same ranks ---------------------
        if decomposition is not None and decomposition not in (
                "auto", "slab", "pencil"):
            raise ValueError(
                f"decomposition must be None, 'auto', 'slab' or 'pencil', "
                f"got {decomposition!r}")
        self.decomposition = decomposition
        self.decomposition_verdict: Optional[dict] = None
        if decomposition is not None:
            topology, self.decomposition_verdict = _resolve_decomposition(
                topology, global_shape, decomposition,
                dict(real=real, dtype=dtype, permute=permute,
                     transform=transform, transforms=transforms,
                     method=method, normalization=normalization,
                     pipeline=pipeline),
                self.batch_dims)
        M = topology.ndims
        if M >= N:
            raise ValueError(
                f"topology ndims ({M}) must be < array ndims ({N}) so that "
                f"at least one dim is local per stage")
        # -- per-dim transform kinds (the JAX package's rules) ------------
        if transforms is None and isinstance(transform, (tuple, list)):
            transforms = transform
            transform = "mixed"
        if transforms is not None:
            kinds = tuple(str(k).lower() for k in transforms)
            if len(kinds) != N:
                raise ValueError(f"transforms has {len(kinds)} entries for a "
                                 f"rank-{N} array")
            for k in kinds:
                if k not in _KINDS:
                    raise ValueError(f"unknown transform kind {k!r}; expected "
                                     f"one of {_KINDS}")
            if real:
                raise ValueError("real=True is implicit in per-dim "
                                 "transforms; spell the real dim 'rfft'")
            transform = "mixed"
        else:
            if transform not in ("fft", "dct", "dst"):
                raise ValueError(f"transform must be 'fft', 'dct' or 'dst', "
                                 f"got {transform!r}")
            if transform in ("dct", "dst") and real:
                raise ValueError(
                    f"real=True is implicit for transform={transform!r}")
            kinds = (("rfft",) + ("fft",) * (N - 1)
                     if transform == "fft" and real else (transform,) * N)
        if kinds.count("rfft") > 1:
            raise ValueError("at most one dim may be 'rfft'")
        complex_seen = False
        for d, k in enumerate(kinds):
            if k in ("rfft", "dct", "dst") and complex_seen:
                raise ValueError(
                    f"transform {k!r} on dim {d} would act on data an "
                    f"earlier 'fft' dim made complex; real-input kinds "
                    f"must come first in stage order")
            if k in ("fft", "rfft"):
                complex_seen = True
        self.transforms = kinds
        self.transform = transform
        self.real = "rfft" in kinds
        self.topology = topology
        self.shape_physical = global_shape
        self.method = method
        self.permute = permute
        if normalization not in ("backward", "ortho", "forward", "none"):
            raise ValueError(
                f"normalization must be 'backward', 'ortho', 'forward' or "
                f"'none', got {normalization!r}")
        self.normalization = normalization

        # -- dtypes -------------------------------------------------------
        needs_real = any(k in ("rfft", "dct", "dst") for k in kinds)
        if dtype is None:
            dtype = torch.float32 if needs_real else torch.complex64
        self.dtype_physical = as_torch_dtype(dtype)
        is_cplx_in = self.dtype_physical.is_complex
        if needs_real and is_cplx_in:
            kr = next(k for k in kinds if k in ("rfft", "dct", "dst"))
            if self.real and transform != "mixed":
                raise ValueError("real=True requires a real input dtype")
            raise ValueError(f"transform {kr!r} requires a real dtype")
        self.dtype_spectral = (_complex_of(self.dtype_physical)
                               if any(k in ("fft", "rfft") for k in kinds)
                               else self.dtype_physical)
        self.shape_spectral = tuple(n // 2 + 1 if k == "rfft" else n
                                    for n, k in zip(global_shape, kinds))

        # -- static schedule (the JAX package's walk) ---------------------
        chain = _build_chain(topology, global_shape, kinds)
        cfgs = [(dec, _stage_permutation(N, d, permute))
                for d, dec in enumerate(chain)]

        def _is_local(pen: Pencil, p: int) -> bool:
            if p not in pen.decomposition:
                return True
            return topology.dims[pen.decomposition.index(p)] == 1

        shape = list(global_shape)
        pending = [d for d in range(N) if kinds[d] != "none"]
        is_complex = is_cplx_in
        steps: List[tuple] = []
        cur = Pencil(topology, tuple(shape), cfgs[0][0],
                     permutation=cfgs[0][1])
        self._input_pencil = cur
        for d in range(N):
            if not pending:
                break
            dec, perm = cfgs[d]
            if dec != cur.decomposition:
                tgt = Pencil(topology, tuple(shape), dec, permutation=perm)
                hop_dtype = (self.dtype_spectral if is_complex
                             else self.dtype_physical)
                steps.append(("t", cur, tgt, hop_dtype))
                cur = tgt
            if d != min(pending):
                continue
            batch_dims = tuple(sorted(p for p in pending if _is_local(cur, p)))
            mem_ids = cur.permutation.apply(tuple(range(N)))
            ops = [(kinds[p], mem_ids.index(p), shape[p]) for p in batch_dims]
            pre = cur
            pre_complex = is_complex
            for p in batch_dims:
                if kinds[p] == "rfft":
                    shape[p] = shape[p] // 2 + 1
            if any(kinds[p] in ("fft", "rfft") for p in batch_dims):
                is_complex = True
            if tuple(shape) != pre.size_global():
                cur = Pencil(topology, tuple(shape), pre.decomposition,
                             permutation=pre.permutation)
            steps.append(("f", pre, cur, tuple(ops), pre_complex))
            pending = [p for p in pending if p not in batch_dims]
        self._steps = tuple(steps)
        self._output_pencil = cur

        # -- pipelined hop fusion: each eligible ("t", "f") pair becomes
        # one ("ft", ...) step (the JAX package's rewrite, kind for kind)
        self.pipeline = pipeline
        if pipeline == "auto":
            verdict = _pipeline_sweep_verdict(
                f"torch-{topology.device.type}")
            try:
                k_req = int(verdict["best_k"]) if verdict else None
            except (TypeError, ValueError, KeyError):
                k_req = None
            if k_req is None or k_req < 1:
                k_req = _PIPELINE_AUTO_DEFAULT_K
        else:
            k_req = int(pipeline) if pipeline is not None else 1
        self.pipeline_chunks = k_req
        if k_req > 1:
            self._steps = self._fuse_pipeline_steps(self._steps, k_req)

        # -- memory-bounded schedule: over-budget hops time-sliced, or a
        # typed HbmBoundError naming the hop
        self.hbm_limit = None
        if hbm_limit is not None:
            try:
                lim = (None if isinstance(hbm_limit, bool)
                       else int(hbm_limit))
            except (TypeError, ValueError):
                lim = None
            if lim is None or lim < 1:
                raise ValueError(
                    f"hbm_limit must be None or a positive int (bytes "
                    f"per rank), got {hbm_limit!r}")
            self.hbm_limit = lim
            self._steps = self._bound_steps_hbm(self._steps, lim)

        self._pencils: List[Pencil] = []
        sh = list(global_shape)
        for d in range(N):
            self._pencils.append(Pencil(topology, tuple(sh), cfgs[d][0],
                                        permutation=cfgs[d][1]))
            if kinds[d] == "rfft":
                sh[d] = sh[d] // 2 + 1

        from .. import guard, obs

        if _probe:
            # a candidate of the decomposition search: priced and
            # dropped, so it neither journals nor enters the guard's
            # plan-fingerprint ring
            return
        if obs.enabled() or guard.enabled():
            summary = self._summary()
        if obs.enabled():
            obs.counter("fft.plans_built").inc()
            obs.counter("plan.decomposition",
                        verdict=(self.decomposition_verdict or {}).get(
                            "family", "fixed")).inc()
            # later records (hops, faults, probes) carry the plan's key
            from ..obs import correlate
            from ..parallel.routing import plan_fingerprint

            correlate.set_plan(plan_fingerprint(summary))
            obs.record_event("plan.build", **summary)
        if guard.enabled():
            # crash bundles carry the schedules of recently built plans
            guard.note_plan("fft_plan", summary)

    # -- pencils ----------------------------------------------------------
    @property
    def pencils(self) -> Tuple[Pencil, ...]:
        return tuple(self._pencils)

    @property
    def input_pencil(self) -> Pencil:
        return self._input_pencil

    @property
    def output_pencil(self) -> Pencil:
        """Configuration of the spectral (fully transformed) array."""
        return self._output_pencil

    def _fuse_pipeline_steps(self, steps: tuple, K: int) -> tuple:
        """Rewrite every eligible hop + stage pair into one fused ``"ft"``
        step (:func:`_fuse_spec`); the rest keep the serialized schedule."""
        fused: List[tuple] = []
        i = 0
        while i < len(steps):
            s = steps[i]
            if (s[0] == "t" and i + 1 < len(steps)
                    and steps[i + 1][0] == "f"
                    and steps[i + 1][1] == s[2]):
                step = _fuse_spec(s, steps[i + 1], K, self.method)
                if step is not None:
                    fused.append(step)
                    i += 2
                    continue
            fused.append(s)
            i += 1
        return tuple(fused)

    def _bound_steps_hbm(self, steps: tuple, limit: int) -> tuple:
        """Every exchange step whose modeled peak
        (:func:`~pencilarrays_tpu_torch.analysis.step_hop_peak`) exceeds
        ``limit`` at :attr:`batch_dims` rewritten into its smallest
        fitting time-sliced variant (bit-identical, count times K), or a
        :class:`~pencilarrays_tpu_torch.analysis.HbmBoundError` naming
        the hop."""
        from ..analysis import HbmBoundError, step_hop_peak

        extra = self.batch_dims
        out = []
        for idx, s in enumerate(steps):
            if s[0] not in ("t", "ft"):
                out.append(s)
                continue
            peak = step_hop_peak(s, extra, method=self.method,
                                 wire_dtype=self.wire_dtype)
            if peak <= limit:
                out.append(s)
                continue
            fixed = self._chunk_step_to_fit(s, extra, limit)
            if fixed is None:
                raise HbmBoundError(
                    "plan", f"hop[{idx}] {s[1].decomposition}->"
                            f"{s[2].decomposition}", peak, limit)
            out.append(fixed)
        return tuple(out)

    def _chunk_step_to_fit(self, s: tuple, extra: tuple, limit: int):
        """The smallest time-slicing of one over-budget step that fits
        (K doubling from its chunking, then the chunk dim's extent): a
        fused step re-chunks its bounds, a ``"t"`` step gains a
        ``Pipelined`` method of its own; ``None`` when nothing fits."""
        from ..analysis import step_hop_peak

        src, dst = s[1], s[2]
        R = assert_compatible(src, dst)
        if R is None or src.topology.dims[R] == 1:
            return None
        ext = _exchange_operand_extents(src, dst, R)

        def k_sweep(k0: int, n: int):
            k = k0
            while k < n:
                yield k
                k *= 2
            yield n

        if s[0] == "ft":
            bounds, c = s[9], s[8]
            n = int(ext[c])
            for K in k_sweep(len(bounds) * 2, n):
                nb = _chunk_bounds(n, K)
                if len(nb) <= len(bounds):
                    continue
                cand = s[:9] + (nb,)
                if step_hop_peak(cand, extra) <= limit:
                    return cand
            return None
        hop_dtype = s[3]
        method = s[4] if len(s) > 4 else self.method
        if isinstance(method, Auto):
            method = resolve_method(src, dst, extra, hop_dtype, method)
        k0 = 2
        if isinstance(method, Pipelined):
            k0, method = method.chunks * 2, method.base
        shape = tuple(ext) + tuple(extra)
        c = _pipeline_chunk_axis(shape, src.decomposition[R],
                                 dst.decomposition[R])
        if c is None:
            return None
        n = int(shape[c])
        for K in k_sweep(k0, n):
            if len(_chunk_bounds(n, K)) <= 1:
                continue
            cand = ("t", src, dst, hop_dtype,
                    Pipelined(chunks=K, base=method))
            if step_hop_peak(cand, extra) <= limit:
                return cand
        return None

    def plan_key(self) -> str:
        """Stable fingerprint of the plan's static configuration (12 hex
        characters of the sha256 of its schedule summary): shape, kinds,
        dtype, topology, method, normalization, pipeline, batch,
        decomposition verdict, the hop-by-hop schedule and its predicted
        costs, and the wire where there is one.  The summary is the JAX
        package's, so is the key."""
        from ..parallel.routing import plan_fingerprint

        return plan_fingerprint(self._summary())

    def _summary(self) -> dict:
        steps = []
        for s in self._steps:
            if s[0] == "t":
                entry = {"kind": "t",
                         "hop": f"{s[1].decomposition}->{s[2].decomposition}",
                         "dtype": _dtype_name(s[3])}
                if len(s) > 4:
                    entry["method"] = _method_label(s[4])
                steps.append(entry)
            elif s[0] == "ft":
                (_, src, tgt, hop_dtype, _post, ops, _pc, base, c,
                 bounds) = s
                steps.append({"kind": "ft",
                              "hop": f"{src.decomposition}->"
                                     f"{tgt.decomposition}",
                              "dtype": _dtype_name(hop_dtype),
                              "base": _method_label(base),
                              "chunk_dim": c, "chunks": len(bounds),
                              "transforms": [op[0] for op in ops]})
            else:
                steps.append({"kind": "f",
                              "transforms": [op[0] for op in s[3]]})
        if self.decomposition_verdict is not None:
            decomp = {k: v for k, v in self.decomposition_verdict.items()
                      if k != "candidates"}
            decomp["n_candidates"] = len(
                self.decomposition_verdict["candidates"])
        else:
            decomp = {"mode": "fixed", "winner": list(self.topology.dims)}
        summary = {
            "shape": list(self.shape_physical),
            "transforms": list(self.transforms),
            "dtype": _dtype_name(self.dtype_physical),
            "topo": list(self.topology.dims),
            "method": _method_label(self.method)
            if not isinstance(self.method, Auto)
            else f"Auto({self.method.mode})"
            + (f"[wire={self.method.wire_dtype}]"
               if self.method.wire_dtype else ""),
            "pipeline": self.pipeline_chunks,
            "normalization": self.normalization,
            "extra_dims": list(self.batch_dims),
            "decomposition": decomp,
            "steps": steps,
            "predicted_costs": self.collective_costs(),
        }
        if self.wire_dtype is not None:
            summary["wire_dtype"] = self.wire_dtype
        return summary

    def with_wire_dtype(self, wire_dtype) -> "PencilFFTPlan":
        """This schedule at another wire precision (``None`` strips the
        wire): the plan rebuilt from its own resolved attributes with the
        method's wire replaced, so :meth:`plan_key` differs by the wire
        alone.  Variants are cached per wire on the plan."""
        wire = _wire.canonical_wire_dtype(wire_dtype)
        if wire == self.wire_dtype:
            return self
        cache = self.__dict__.setdefault("_wire_variant_cache", {})
        if wire in cache:
            return cache[wire]
        variant = PencilFFTPlan(
            self.topology, self.shape_physical,
            transforms=self.transforms, dtype=self.dtype_physical,
            permute=self.permute,
            method=with_wire(strip_wire(self.method), wire),
            normalization=self.normalization,
            pipeline=(self.pipeline_chunks
                      if self.pipeline_chunks > 1 else None),
            batch=self.batch, hbm_limit=self.hbm_limit)
        variant.decomposition = self.decomposition
        variant.decomposition_verdict = self.decomposition_verdict
        cache[wire] = variant
        return variant

    def collective_costs(self, extra_dims: Optional[Tuple[int, ...]] = None
                         ) -> dict:
        """Predicted per-rank collective cost of ONE :meth:`forward`, in
        the JAX package's ``{op: {"count", "bytes"}}`` schema: each hop by
        the plan's method (or its own, once ``hbm_limit`` time-sliced it),
        a fused hop by its base with its own chunks, at the wire's
        bytes."""
        if extra_dims is None:
            extra_dims = self.batch_dims
        extra_dims = tuple(int(e) for e in extra_dims)
        total: dict = {}
        for src, dst, hop_dtype, base, k_mult, chunk in _iter_priced_hops(
                self._steps):
            m = self.method if base is None else base
            for op, c in transpose_cost(src, dst, extra_dims, hop_dtype, m,
                                        chunk=chunk).items():
                e = total.setdefault(op, {"count": 0, "bytes": 0})
                e["count"] += c["count"]
                e["bytes"] += c["bytes"]
        return total

    def allocate_input(self, extra_dims: Optional[Tuple[int, ...]] = None
                       ) -> PencilArray:
        if extra_dims is None:
            extra_dims = self.batch_dims
        return PencilArray.zeros(self.input_pencil, extra_dims,
                                 self.dtype_physical)

    def allocate_output(self, extra_dims: Optional[Tuple[int, ...]] = None
                        ) -> PencilArray:
        if extra_dims is None:
            extra_dims = self.batch_dims
        return PencilArray.zeros(self.output_pencil, extra_dims,
                                 self.dtype_spectral)

    def predicted_wire_bytes(self, extra_dims: Optional[Tuple[int, ...]]
                             = None) -> int:
        """Predicted per-rank collective bytes of ONE forward (or
        backward), at the wire's bytes: the scalar an engine dispatch
        carries (``meta["wire_bytes"]``) and ``analysis.spmd.
        verify_dispatch_log`` re-checks against the priced schedule."""
        if extra_dims is None:
            extra_dims = self.batch_dims
        key = tuple(int(e) for e in extra_dims)
        cache = self.__dict__.setdefault("_wire_bytes_cache", {})
        if key not in cache:
            cache[key] = sum(v["bytes"] for v in
                             self.collective_costs(key).values())
        return cache[key]

    def compile(self, extra_dims: Optional[Tuple[int, ...]] = None, *,
                donate: bool = False,
                _counters: bool = True) -> "CompiledPlan":
        """The whole forward and backward chains as one replay each
        (:class:`CompiledPlan`): on the card, one CUDA graph per
        direction, captured at its first call; on the CPU the eager
        chain behind the same object.  Results are bit-identical to
        :meth:`forward`/:meth:`backward`.  ``extra_dims`` defaults to
        :attr:`batch_dims`; ``donate=True`` gives up each call's input
        (it is invalid afterwards).  Cached per ``(extra_dims,
        donate)`` on the plan; every executable of the plan captures into
        the plan's one graph memory pool, and :meth:`release_compiled`
        frees them.  ``_counters=False`` skips the plan-level cache
        counters (a caller counting its own resolve, as the serve
        registry does)."""
        if extra_dims is None:
            extra_dims = self.batch_dims
        key = (tuple(int(e) for e in extra_dims), bool(donate))
        cache = self.__dict__.setdefault("_compiled_plans", {})
        hit = key in cache
        if not hit:
            cache[key] = CompiledPlan(self, key[0], donate=key[1])
        from .. import obs

        if _counters and obs.enabled():
            obs.counter(f"compile.cache_{'hits' if hit else 'misses'}",
                        cache="plan").inc()
        return cache[key]

    def release_compiled(self) -> int:
        """Free the CUDA graphs of every executable :meth:`compile` made
        for this plan (each recaptures at its next call) and with the
        last of them the plan's graph memory pool; returns the number of
        graphs freed (0 on the CPU).  The memory goes back to the
        allocator's cache once no result of :meth:`CompiledPlan.replay`
        that the caller kept lies in the pool."""
        cache = self.__dict__.get("_compiled_plans", {})
        return sum(cp.release() for cp in list(cache.values()))

    def forward_async(self, u: Optional[PencilArray] = None, *,
                      pack=None, engine=None, donate: bool = False):
        """Submit one forward transform as an ordered engine dispatch;
        returns its :class:`~pencilarrays_tpu_torch.engine.StepFuture`.
        Exactly one of ``u`` (a ready :class:`PencilArray`) or ``pack``
        (a zero-argument callable run on the engine's host pool that
        returns the sample in the plan's global logical shape, scattered
        by ``from_global`` on the consumer thread).  ``donate=True`` gives
        up ``u`` once the dispatch ran.  The dispatch records its exchange
        calls in its ``meta`` for ``verify_dispatch_log``."""
        return self._submit_async("forward", u, pack, engine, donate)

    def backward_async(self, uh: Optional[PencilArray] = None, *,
                       pack=None, engine=None, donate: bool = False):
        """The mirrored :meth:`forward_async` (spectral -> physical; a
        ``pack`` callable returns the spectral-shape host sample)."""
        return self._submit_async("backward", uh, pack, engine, donate)

    def _submit_async(self, direction: str, u, pack, engine,
                      donate: bool):
        from ..engine import get_engine

        eng = engine if engine is not None else get_engine()
        if (u is None) == (pack is None):
            raise ValueError(
                f"{direction}_async needs exactly one of u= (a ready "
                f"PencilArray) or pack= (a host-pool operand builder)")
        fwd = direction == "forward"
        run_plan = self.forward if fwd else self.backward
        label = f"fft.{direction}:{self.plan_key()[:8]}"
        meta = {"plan": self, "direction": direction,
                "wire_dtype": self.wire_dtype}

        def counted(arr: PencilArray, give_up: bool) -> PencilArray:
            # the collectives of this dispatch that cross ranks: the
            # consumer thread issues this chain's exchanges
            meta["extra_dims"] = tuple(arr.extra_dims)
            meta["wire_bytes"] = self.predicted_wire_bytes(arr.extra_dims)
            with _collectives.recording() as rec:
                out = run_plan(arr)
            if give_up:
                arr._donate()
            meta["collectives"] = _collectives.stats(
                rec["ops"], _collectives.EXCHANGE_KINDS)
            return out

        if pack is None:
            return eng.submit(lambda: counted(u, donate), label=label,
                              meta=meta)
        pen = self.input_pencil if fwd else self.output_pencil
        dt = self.dtype_physical if fwd else self.dtype_spectral
        base_ndim = len(self.shape_physical)

        def run(host):
            host = torch.as_tensor(np.asarray(host)).to(dt)
            arr = PencilArray.from_global(
                pen, host, extra_ndims=host.dim() - base_ndim)
            return counted(arr, True)

        return eng.submit(run, pack=pack, label=label, meta=meta)

    def _stage(self, data: torch.Tensor, ops, inverse: bool,
               pre_complex: bool) -> torch.Tensor:
        N = len(self.shape_physical)
        with span("stage_compute"):
            return _stage_op(ops, inverse, pre_complex, self.normalization,
                             N)(data)

    def forward(self, u: PencilArray) -> PencilArray:
        """Physical -> spectral: the static schedule, in order."""
        if u.pencil != self.input_pencil:
            raise ValueError(f"input must live on plan.input_pencil "
                             f"({self.input_pencil!r}), got {u.pencil!r}")
        with span("plan.forward"):
            from .. import obs

            if obs.enabled():
                from ..obs import correlate

                correlate.set_plan(self.plan_key())
            tap = self._guard_tap_pre(u)
            x = u
            for step in self._steps:
                if step[0] == "t":
                    x = transpose(x, step[2], method=(
                        step[4] if len(step) > 4 else self.method))
                elif step[0] == "ft":
                    (_, src, tgt, hop_dtype, post, ops, pre_complex, base, c,
                     bounds) = step
                    x = PencilArray(post, self._dispatch_fused(
                        x, src, tgt, hop_dtype, base, bounds,
                        lambda d: _fused_hop(
                            d, src, tgt, post, x.ndims_extra, ops, False,
                            pre_complex, self.normalization, base, c, bounds)),
                        x.extra_dims)
                else:
                    _, pre, post, ops, pre_complex = step
                    x = PencilArray(post, self._stage(
                        x.data, ops, False, pre_complex), x.extra_dims)
            if x.dtype != self.dtype_spectral:
                x = x.astype(self.dtype_spectral)
            self._guard_tap_post(tap, "fft.forward", x)
            return x

    @staticmethod
    def _dispatch_fused(x: PencilArray, hop_src: Pencil, hop_tgt: Pencil,
                        hop_dtype, base, bounds, fn) -> torch.Tensor:
        """One fused pipelined hop under the ``transpose!`` span, journaled
        as a ``hop`` with observability on (the transpose tap,
        ``fused(K=..)`` in its key, since its time includes the stage);
        ``hop_src -> hop_tgt`` is the direction the data moves."""
        from .. import obs

        if not obs.enabled():
            with span("transpose!"):
                return fn(x.data)
        import time

        t0 = time.perf_counter()
        with span("transpose!"):
            data = fn(x.data)
        _obs_record_hop(hop_src, hop_tgt, assert_compatible(hop_src,
                                                            hop_tgt),
                        base, x.extra_dims, hop_dtype,
                        time.perf_counter() - t0, fused_k=len(bounds))
        return data

    def _guard_tap_pre(self, u: PencilArray) -> bool:
        """The sampled finiteness tap, input side (the "NaN born mid-FFT"
        detector): True when the guard sampled this call and the input
        (every rank's block) is wholly finite.  One cached probe when the
        guard is off."""
        from .. import guard

        if not guard.enabled() or not guard.finite_tick():
            return False
        from ..guard import integrity as gi

        return gi.nonfinite_count(u.data, _probe_group(self.topology)) == 0

    def _guard_tap_post(self, tap: bool, label: str, x: PencilArray) -> None:
        """Output side of the tap: a nonfinite value born across the
        transform chain raises a typed ``IntegrityError`` (``guard.sdc``,
        a crash bundle) instead of flowing downstream."""
        if not tap:
            return
        from ..guard import integrity as gi

        gi.report_nonfinite_birth(
            label, gi.nonfinite_count(x.data, _probe_group(self.topology)),
            ctx={"shape": list(x.pencil.size_global())})

    def backward(self, uh: PencilArray) -> PencilArray:
        """Spectral -> physical (inverse transforms, reverse schedule)."""
        if uh.pencil != self.output_pencil:
            raise ValueError(f"input must live on plan.output_pencil "
                             f"({self.output_pencil!r}), got {uh.pencil!r}")
        with span("plan.backward"):
            from .. import obs

            if obs.enabled():
                from ..obs import correlate

                correlate.set_plan(self.plan_key())
            tap = self._guard_tap_pre(uh)
            x = uh
            for step in reversed(self._steps):
                if step[0] == "t":
                    x = transpose(x, step[1], method=(
                        step[4] if len(step) > 4 else self.method))
                elif step[0] == "ft":
                    (_, src, tgt, hop_dtype, post, ops, pre_complex, base, c,
                     bounds) = step
                    x = PencilArray(src, self._dispatch_fused(
                        x, tgt, src, hop_dtype, base, bounds,
                        lambda d: _fused_hop(
                            d, src, tgt, post, x.ndims_extra, ops, True,
                            pre_complex, self.normalization, base, c, bounds)),
                        x.extra_dims)
                else:
                    _, pre, post, ops, pre_complex = step
                    x = PencilArray(pre, self._stage(
                        x.data, ops, True, pre_complex), x.extra_dims)
            if x.dtype != self.dtype_physical:
                x = x.astype(self.dtype_physical)
            self._guard_tap_post(tap, "fft.backward", x)
            return x

    def scale_factor(self) -> float:
        """``backward(forward(u)) == scale_factor() * u`` (1 except for
        ``normalization="none"``)."""
        if self.normalization != "none":
            return 1.0
        out = 1.0
        for n, k in zip(self.shape_physical, self.transforms):
            if k in ("fft", "rfft"):
                out *= float(n)
        return out

    # -- spectral helpers -------------------------------------------------
    @property
    def dtype_real(self) -> torch.dtype:
        """Real dtype matching the plan's arithmetic (f32 for c64 etc.)."""
        return torch.empty((), dtype=self.dtype_spectral).real.dtype

    def frequencies(self, d: int, *, spacing: float = 1.0) -> np.ndarray:
        """Global frequency vector of logical dim ``d`` in cycles per unit,
        in :attr:`dtype_real` (NumPy, host side)."""
        n = self.shape_physical[d]
        k = self.transforms[d]
        rd = np.dtype(str(self.dtype_real).replace("torch.", ""))
        if k == "none":
            raise ValueError(f"dim {d} has transform 'none': no frequencies")
        if k == "rfft":
            return np.fft.rfftfreq(n, d=spacing).astype(rd)
        return np.fft.fftfreq(n, d=spacing).astype(rd)

    def _mode_vector(self, d: int) -> np.ndarray:
        rd = np.dtype(str(self.dtype_real).replace("torch.", ""))
        if self.transforms[d] == "none":
            return np.zeros(self.shape_spectral[d], rd)
        return self.frequencies(d) * rd.type(self.shape_physical[d])

    def wavenumbers(self, order=MemoryOrder) -> Tuple[torch.Tensor, ...]:
        """Broadcast-shaped mode numbers of the OUTPUT pencil, one tensor
        per logical dim, on the topology's device.

        ``LogicalOrder``: true-size, non-singleton at logical position
        ``d`` — for arithmetic against PencilArrays.  ``MemoryOrder``
        (default): this rank's slice, zero-padded to the padded local
        extent, non-singleton at ``d``'s memory position — for arithmetic
        against ``.data``."""
        pen = self.output_pencil
        N = pen.ndims
        dev = self.topology.device
        ks = []
        if order is LogicalOrder:
            for d in range(N):
                shape = [1] * N
                shape[d] = self.shape_spectral[d]
                ks.append(torch.from_numpy(self._mode_vector(d))
                          .reshape(shape).to(dev))
            return tuple(ks)
        mem_ids = pen.permutation.apply(tuple(range(N)))
        ranges = pen.range_local()
        padded = pen.padded_size_local(LogicalOrder)
        for d in range(N):
            k = self._mode_vector(d)[ranges[d].start:ranges[d].stop]
            k = np.pad(k, (0, padded[d] - k.shape[0]))
            shape = [1] * N
            shape[mem_ids.index(d)] = padded[d]
            ks.append(torch.from_numpy(k).reshape(shape).to(dev))
        return tuple(ks)

    def __repr__(self) -> str:
        return (f"PencilFFTPlan({'x'.join(self.transforms)}, "
                f"shape={self.shape_physical}, topo={self.topology.dims}, "
                f"permute={self.permute})")


_pools_lock = threading.Lock()


class _GraphPool:
    """One plan's CUDA graph memory pool, shared by the graphs of every
    :class:`CompiledPlan` of the plan.  Graphs of one pool overwrite
    each other's intermediates and static outputs, so each replay runs
    under :attr:`lock`, from the copy of its input to the copy of its
    output, and its stream waits for :attr:`done`, the event recorded
    after the previous replay's copy-out, whichever stream that ran on.
    A pool whose last graph was freed is retired: the allocator frees it
    and refuses to capture into it again, so the plan makes a new one."""

    def __init__(self):
        self.handle = torch.cuda.graph_pool_handle()
        self.lock = threading.RLock()
        self.members: "weakref.WeakSet[CompiledPlan]" = weakref.WeakSet()
        self.done: Optional[torch.cuda.Event] = None
        self.retired = False


def _plan_pool(plan: "PencilFFTPlan") -> _GraphPool:
    with _pools_lock:
        pool = plan.__dict__.get("_graph_pool")
        if pool is None:
            pool = plan.__dict__["_graph_pool"] = _GraphPool()
        return pool


class CompiledPlan:
    """One replay for each of a plan's full transform chains (built by
    :meth:`PencilFFTPlan.compile`), the JAX package's whole-plan
    executable.

    On the card each direction is one CUDA graph, captured at its first
    call: a warm-up run first (cuFFT plans, the K1 library, K1's
    shared-memory opt-in), then the chain captured with a static input
    block.  :meth:`forward` copies its input into the static block,
    replays the graph and returns a fresh copy of the static output, so
    every result stays valid (as JAX's do).  Every executable of one
    plan (each ``extra_dims`` and donate variant, both directions)
    captures into the plan's ONE graph memory pool (a served plan holds
    one pool for all its batch sizes), so the replays of a plan are
    serialized: each runs under the pool's lock from the copy of its
    input to the copy of its output, and on the card after the previous
    replay's copy-out, from whichever thread and stream they come.
    :meth:`replay` hands the static output to a callback under the same
    lock.  :meth:`release` frees the graphs.  A capture runs in
    ``thread_local`` error mode and empties no allocator cache, so
    host-pool work of other threads on other streams goes on beside it.
    A capture that fails raises; nothing falls back to the eager chain
    on the card.  A chain with exchanges across ranks holds NCCL calls
    in its graph; that is not verified on several cards yet.  On the
    CPU the object runs the eager chain.  ``donate=True`` gives up the
    caller's input after each call."""

    def __init__(self, plan: PencilFFTPlan, extra_dims: Tuple[int, ...],
                 *, donate: bool = False):
        self.plan = plan
        self.extra_dims = tuple(extra_dims)
        self.donate = bool(donate)
        self.graphed = plan.topology.device.type == "cuda"
        self._graphs: dict = {}
        self._pool: Optional[_GraphPool] = None
        self.replays = 0
        """Graph replays since construction (the card's calls)."""

    @property
    def pool_handle(self):
        """The graph memory pool its captured graphs live in (None before
        a capture, after :meth:`release`, and on the CPU)."""
        return None if self._pool is None else self._pool.handle

    def _check(self, u: PencilArray, pen, what: str) -> None:
        if u.pencil != pen:
            raise ValueError(
                f"input must live on plan.{what} ({pen!r}), got {u.pencil!r}")
        if u.extra_dims != self.extra_dims:
            raise ValueError(
                f"compiled for extra_dims={self.extra_dims}, got "
                f"{u.extra_dims} (compile() again for this batch shape)")

    def graph_info(self, direction: str) -> Optional[dict]:
        """A captured direction's ``{"k1_launches", "collectives"}``: the
        K1 launches its graph recorded (each replayed on every call) and
        the collectives it issued while captured
        (``parallel/collectives.py`` records, what ``analysis.spmd.
        trace_compiled_plan`` reads); ``None`` before
        the direction's first call, after :meth:`release` or on the CPU.
        The pool's bytes are read where they are reported
        (:meth:`~pencilarrays_tpu_torch.serve.registry.PlanRegistry.
        graph_info`, from :attr:`pool_handle`)."""
        g = self._graphs.get(direction)
        return None if g is None else dict(g[3])

    def _capture(self, direction: str, pool: _GraphPool):
        plan = self.plan
        fwd = direction == "forward"
        pen = plan.input_pencil if fwd else plan.output_pencil
        out_pen = plan.output_pencil if fwd else plan.input_pencil
        dtype = plan.dtype_physical if fwd else plan.dtype_spectral
        run = plan.forward if fwd else plan.backward
        dev = plan.topology.device
        static = torch.zeros(pen.padded_size_local(MemoryOrder)
                             + self.extra_dims, dtype=dtype, device=dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            run(PencilArray(pen, static, self.extra_dims))
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        before = k1.launches
        with _collectives.recording() as rec, torch.cuda.graph(
                graph, pool=pool.handle, capture_error_mode="thread_local"):
            out = run(PencilArray(pen, static, self.extra_dims)).data
        info = {"k1_launches": k1.launches - before,
                "collectives": rec["ops"]}
        self._graphs[direction] = (graph, static, out, info, out_pen)
        self._pool = pool
        pool.members.add(self)
        return self._graphs[direction]

    def _call(self, u: PencilArray, direction: str, take=None):
        plan = self.plan
        fwd = direction == "forward"
        if not self.graphed:
            out = (plan.forward if fwd else plan.backward)(u)
            if self.donate:
                u._donate()
            return out if take is None else take(out)
        while True:
            pool = self._pool or _plan_pool(plan)
            with pool.lock:
                if pool.retired:
                    continue        # retired meanwhile: the plan's new one
                g = self._graphs.get(direction) or self._capture(direction,
                                                                 pool)
                graph, static, res, _, out_pen = g
                if u.data.dtype != static.dtype:
                    raise ValueError(f"compiled for {static.dtype}, got "
                                     f"{u.data.dtype}")
                stream = torch.cuda.current_stream(plan.topology.device)
                if pool.done is not None:
                    stream.wait_event(pool.done)
                static.copy_(u.data)
                graph.replay()
                self.replays += 1
                _collectives.replayed(g[3]["collectives"])
                out = (PencilArray(out_pen, res.clone(), self.extra_dims)
                       if take is None else
                       take(PencilArray(out_pen, res, self.extra_dims)))
                pool.done = torch.cuda.Event()
                pool.done.record(stream)
                break
        if self.donate:
            u._donate()
        return out

    def replay(self, u: PencilArray, direction: str, take):
        """One call of ``direction`` whose result, on the card the
        graph's static output itself, goes to ``take(result)`` under the
        pool's lock: ``take`` copies out what it keeps (the serve layer's
        split copies each sample into storage of its own) before any
        other replay of the plan's pool can overwrite it.  Returns what
        ``take`` returns.  On the CPU ``take`` gets the eager chain's
        fresh result."""
        pen = (self.plan.input_pencil if direction == "forward"
               else self.plan.output_pencil)
        self._check(u, pen, "input_pencil" if direction == "forward"
                    else "output_pencil")
        return self._call(u, direction, take)

    def release(self) -> int:
        """Free this executable's CUDA graphs (the next call recaptures)
        and, when they were the last in the plan's graph pool, retire the
        pool; returns the number of graphs freed."""
        while True:
            pool = self._pool
            if pool is None:
                return 0
            with pool.lock:
                if self._pool is not pool:
                    continue        # released and recaptured meanwhile
                n = len(self._graphs)
                self._graphs.clear()
                self._pool = None
                pool.members.discard(self)
                if not len(pool.members):
                    with _pools_lock:
                        pool.retired = True
                        if self.plan.__dict__.get("_graph_pool") is pool:
                            del self.plan.__dict__["_graph_pool"]
                return n

    def forward(self, u: PencilArray) -> PencilArray:
        """Physical -> spectral, one replay."""
        self._check(u, self.plan.input_pencil, "input_pencil")
        return self._call(u, "forward")

    def backward(self, uh: PencilArray) -> PencilArray:
        """Spectral -> physical, one replay."""
        self._check(uh, self.plan.output_pencil, "output_pencil")
        return self._call(uh, "backward")

    def __repr__(self) -> str:
        return (f"CompiledPlan({self.plan!r}, extra_dims={self.extra_dims}, "
                f"donate={self.donate})")
