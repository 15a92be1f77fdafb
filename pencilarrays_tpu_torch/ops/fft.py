"""Distributed N-D FFT over pencil decompositions — the PencilFFTs layer.

PyTorch counterpart of the JAX package's ``ops/fft.py``.  The plan is the
same static schedule, built by the same code: the extent-aware stage chain
(:func:`_build_chain`), one pencil permutation per stage placing the
stage's transform dim last in memory (``permute=True``), and at each stage
ONE batched local transform over every pending dim that is local there.
Between stages the transpose engine moves the data
(``parallel/transpositions.py``).  Each rank transforms its own block with
``torch.fft`` (cuFFT on the card): a library call for what the JAX package
leaves to XLA.

One layout step is the port's own.  A pencil block keeps its extra dims
(vector components, a ``batch=B`` plan's samples) innermost, so handed to
``torch.fft`` as it is, each transform would be a strided batch entry.  A
stage with extra dims instead moves them outermost with kernel K1 before
the transform and back after it (two K1 launches per stage), so cuFFT sees
one contiguous signal per batch entry.  ``chip_smoke.py`` (``fft_strided``)
times this against one strided-batch call on the card; see ``PERF.md``.

Normalization is applied as the JAX package applies it: bare transforms
("backward" semantics) followed by a multiply with a Python float, never
through ``torch.fft``'s ``norm=``.

Kinds ``fft``/``rfft``/``none`` and all four normalizations are ported.
``dct``/``dst``, ``decomposition=``, ``pipeline=``, ``hbm_limit=``,
``wire_dtype=`` and ``compile()`` raise ``NotImplementedError`` naming the
ROADMAP item that queues them.
"""

from __future__ import annotations

from itertools import permutations as _iperms
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel.arrays import PencilArray, as_torch_dtype
from ..parallel.pencil import LogicalOrder, MemoryOrder, Pencil
from ..parallel.topology import Topology
from ..parallel.transpositions import (
    AllToAll,
    AbstractTransposeMethod,
    transpose,
    transpose_cost,
)
from ..utils.permutations import Permutation
from . import permute as k1

__all__ = ["PencilFFTPlan"]

_KINDS = ("fft", "rfft", "dct", "dst", "none")
_LATER = ("not ported yet: ROADMAP.md Queue 1, item 'Transpose methods and "
          "plan options beyond the first slice'")


def _stage_op(ops: tuple, inverse: bool, pre_complex: bool, norm: str,
              nspace: int):
    """Per-block batched local transform of one schedule step.

    ``ops`` is a tuple of ``(kind, mem_axis, n_logical)`` — every transform
    applied at this stage, along axes local in the stage pencil.  Blocks
    carry ``nspace`` spatial dims followed by their extra dims."""
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
        return blk

    def op(blk):
        E = blk.dim() - nspace
        if not four:
            return blk
        if E == 0:
            return transform(blk, 0)
        front = tuple(range(nspace, nspace + E)) + tuple(range(nspace))
        back = tuple(range(E, E + nspace)) + tuple(range(E))
        out = transform(k1.permute(blk.contiguous(), front), E)
        return k1.permute(out.contiguous(), back)

    return op


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


class PencilFFTPlan:
    """Plan for a distributed N-D transform with per-dimension kinds
    (PencilFFTs' ``PencilFFTPlan``).  Arguments as in the JAX package:
    ``transforms`` (or ``real=True`` for ``rfft x fft x ...``),
    ``normalization`` in ``backward | ortho | forward | none``, and
    ``batch=B`` for B transforms sharing one schedule (extra dims
    ``(B,)``)."""

    def __init__(self, topology: Topology, global_shape: Sequence[int], *,
                 real: bool = False, dtype=None, permute: bool = True,
                 transform="fft", transforms: Sequence[str] = None,
                 method: AbstractTransposeMethod = AllToAll(),
                 normalization: str = "backward", pipeline=None,
                 batch: Optional[int] = None, decomposition=None,
                 wire_dtype=None, hbm_limit=None):
        for name, val, ok in (("pipeline", pipeline, (None, 1)),
                              ("decomposition", decomposition, (None,)),
                              ("wire_dtype", wire_dtype, (None,)),
                              ("hbm_limit", hbm_limit, (None,))):
            if val not in ok:
                raise NotImplementedError(f"PencilFFTPlan({name}=...) is "
                                          f"{_LATER}")
        if not isinstance(method, AllToAll):
            raise NotImplementedError(f"transpose method {method!r} is "
                                      f"{_LATER}")
        global_shape = tuple(int(n) for n in global_shape)
        N = len(global_shape)
        if batch is not None and (isinstance(batch, bool)
                                  or not isinstance(batch, int) or batch < 1):
            raise ValueError(
                f"batch must be None or a positive int, got {batch!r}")
        self.batch = batch
        self.batch_dims: Tuple[int, ...] = (int(batch),) if batch else ()
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
            kinds = (("rfft",) + ("fft",) * (N - 1)
                     if transform == "fft" and real else (transform,) * N)
        if any(k in ("dct", "dst") for k in kinds):
            raise NotImplementedError(f"dct/dst transforms are {_LATER}")
        if kinds.count("rfft") > 1:
            raise ValueError("at most one dim may be 'rfft'")
        complex_seen = False
        for d, k in enumerate(kinds):
            if k == "rfft" and complex_seen:
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
        if dtype is None:
            dtype = torch.float32 if self.real else torch.complex64
        self.dtype_physical = as_torch_dtype(dtype)
        is_cplx_in = self.dtype_physical.is_complex
        if self.real and is_cplx_in:
            raise ValueError("real=True requires a real input dtype")
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

        self._pencils: List[Pencil] = []
        sh = list(global_shape)
        for d in range(N):
            self._pencils.append(Pencil(topology, tuple(sh), cfgs[d][0],
                                        permutation=cfgs[d][1]))
            if kinds[d] == "rfft":
                sh[d] = sh[d] // 2 + 1

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

    def collective_costs(self, extra_dims: Optional[Tuple[int, ...]] = None
                         ) -> dict:
        """Predicted per-rank collective cost of ONE :meth:`forward`, in
        the JAX package's ``{op: {"count", "bytes"}}`` schema."""
        if extra_dims is None:
            extra_dims = self.batch_dims
        extra_dims = tuple(int(e) for e in extra_dims)
        total: dict = {}
        for step in self._steps:
            if step[0] != "t":
                continue
            for op, c in transpose_cost(step[1], step[2], extra_dims,
                                        step[3], self.method).items():
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

    def compile(self, *args, **kwargs):
        raise NotImplementedError(f"PencilFFTPlan.compile() is {_LATER}")

    def _stage(self, data: torch.Tensor, ops, inverse: bool,
               pre_complex: bool) -> torch.Tensor:
        N = len(self.shape_physical)
        return _stage_op(ops, inverse, pre_complex, self.normalization,
                         N)(data)

    def forward(self, u: PencilArray) -> PencilArray:
        """Physical -> spectral: the static schedule, in order."""
        if u.pencil != self.input_pencil:
            raise ValueError(f"input must live on plan.input_pencil "
                             f"({self.input_pencil!r}), got {u.pencil!r}")
        x = u
        for step in self._steps:
            if step[0] == "t":
                x = transpose(x, step[2], method=self.method)
            else:
                _, pre, post, ops, pre_complex = step
                x = PencilArray(post, self._stage(x.data, ops, False,
                                                  pre_complex), x.extra_dims)
        if x.dtype != self.dtype_spectral:
            x = x.astype(self.dtype_spectral)
        return x

    def backward(self, uh: PencilArray) -> PencilArray:
        """Spectral -> physical (inverse transforms, reverse schedule)."""
        if uh.pencil != self.output_pencil:
            raise ValueError(f"input must live on plan.output_pencil "
                             f"({self.output_pencil!r}), got {uh.pencil!r}")
        x = uh
        for step in reversed(self._steps):
            if step[0] == "t":
                x = transpose(x, step[1], method=self.method)
            else:
                _, pre, post, ops, pre_complex = step
                x = PencilArray(pre, self._stage(x.data, ops, True,
                                                 pre_complex), x.extra_dims)
        if x.dtype != self.dtype_physical:
            x = x.astype(self.dtype_physical)
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
