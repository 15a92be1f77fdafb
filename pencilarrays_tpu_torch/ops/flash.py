"""K2–K4 — flash attention forward and backward, and their plain versions.

Port of ``ops/flash_pallas.py``.  Arrays keep the JAX package's layout
contract: ``(S, H, *batch, D)``, with ``H`` and the batch dims folded into
one head·batch index ``n = h * B + b``.  A contiguous ``(S, H, *batch, D)``
tensor already IS the folded ``(S, N, D)`` layout, so the kernels read it
in place: nothing is transposed or padded around a launch.

* K2 :func:`flash_attention_fwd` (``csrc/flash_fwd.cu``) — forward flash
  attention with an online softmax; three output modes, as in the JAX
  package: the normalized output, ``return_stats`` (output plus the folded
  ``(m, l)`` row statistics) and ``partials`` (raw ``(m, l, acc)`` in f32,
  which merge exactly across disjoint key sets — one call per ring round).
  Two instances, chosen by :func:`fwd_instance`: ``"wgmma"`` (q, k and
  v all bf16, every ``d``: bf16 tensor cores fed by TMA) and ``"tf32x3"``
  (any f32 operand, every ``d``: tensor cores at f32 accuracy, each f32
  product as three TF32 ones; up to ``d = 256`` fed by ``cp.async``, each
  K/V tile split into its TF32 parts once a CTA, operands read in their
  own dtypes).  Above ``d = 256`` the wgmma and tf32x3 kernels stream K
  and V (and Q, but for the wgmma one up to ``d = 512``) in TMA boxes,
  reduce the scores over the head dim a box at a time in two warp groups
  and split the output columns between them (the tf32x3 one reads f32
  only: a bf16 operand of such a call is widened first).  All load
  16-byte units, so an operand whose data does not start on a 16-byte
  boundary is first copied (counted in :data:`realigned_copies`).  The
  ``"simt"`` instance (register-blocked f32 FMA, ``d <= 256``) is
  retired: only :func:`launch_fwd` with ``instance="simt"`` runs it
  (``chip_smoke.py`` times it);
* K3 and K4 (``csrc/flash_bwd.cu``, ``csrc/flash_bwd_tf32.cu``) — the
  backward as two kernels, dq with key tiles inner and dk/dv with q tiles
  inner, rebuilding each score block from the saved logsumexp
  ``L = m + log l``: :func:`flash_attention_bwd` (grads in the input
  dtypes) and :func:`flash_attention_bwd_partials` (one ring round against
  a global ``L``; f32 grads).  Two instances of each, chosen by
  :func:`bwd_instance` for every head dim: ``"wgmma"`` (q, k, v and dO all
  bf16: tensor cores fed by TMA) and ``"tf32x3"`` (any other mix: tensor
  cores at f32 accuracy, each f32 product as three TF32 ones, fed by
  ``cp.async``); above ``d = 256`` each runs wide kernels that stream
  every operand in TMA boxes, reduce the score products over the head dim
  a box at a time and split the output columns between two warp groups
  (the tf32x3 ones read f32 only: a bf16 operand of such a call is
  widened first).  Both load 16-byte units, so operands not on 16 bytes
  are copied as for K2.

Conventions of the TPU kernels, kept bit for bit where they are defined:
masked scores take ``NEG = finfo(float32).min / 2``; the causal mask is
start-aligned by global position, ``q_offset + i >= kv_offset + j``; key
tiles wholly above the diagonal are skipped; a row with no visible key has
``l == 0`` and returns 0 (normalized mode); for bf16 the probabilities are
rounded to v's dtype before ``P @ V``.  Rows with no visible key return an
unspecified finite value, as in the JAX package.

For CPU tensors every function runs its plain PyTorch version
(``*_plain``, a chunked streaming loop, memory ``O(Sq x chunk)``); for CUDA
tensors it launches the kernel or raises — there is no fallback.  Each
launch adds one to :data:`launches_fwd`, :data:`launches_dq` or
:data:`launches_dkv`, and to its instance's entry of
:data:`launches_fwd_by_instance`, :data:`launches_dq_by_instance` or
:data:`launches_dkv_by_instance`.
"""

from __future__ import annotations

import ctypes
import math
import operator
from typing import Optional, Tuple

import torch

__all__ = [
    "NEG",
    "supported",
    "fwd_instance",
    "bwd_instance",
    "stream_stats",
    "normalize",
    "launch_fwd",
    "launch_dq",
    "launch_dkv",
    "flash_attention_fwd",
    "flash_attention_bwd",
    "flash_attention_bwd_partials",
    "flash_attention_fwd_plain",
    "flash_attention_bwd_plain",
    "flash_attention_bwd_partials_plain",
    "residuals",
]

launches_fwd = 0
"""K2 launches since the last reset (``flash.launches_fwd = 0``)."""
launches_fwd_by_instance = {"wgmma": 0, "tf32x3": 0, "simt": 0}
"""K2 launches by instance (see :func:`fwd_instance`; ``"simt"`` counts
the retired instance's launches by name) since the last reset (set each
entry to 0); they sum to :data:`launches_fwd`."""
realigned_copies = 0
"""Operands of K2 and of K3/K4's wgmma and tf32x3 instances copied to a
fresh allocation because their data did not start on a 16-byte
boundary."""
launches_dq = 0
"""K3 launches since the last reset."""
launches_dq_by_instance = {"wgmma": 0, "tf32x3": 0}
"""K3 launches by instance (see :func:`bwd_instance`); they sum to
:data:`launches_dq`."""
launches_dkv = 0
"""K4 launches since the last reset."""
launches_dkv_by_instance = {"wgmma": 0, "tf32x3": 0}
"""K4 launches by instance (see :func:`bwd_instance`); they sum to
:data:`launches_dkv`."""

NEG = float(torch.finfo(torch.float32).min) / 2   # flash_pallas._NEG
_DEF_CHUNK = 1024   # key rows per step of the plain streaming loop
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_Y = 65535   # the kernels put the head·batch index on gridDim.y


def supported(d: int, *dtypes) -> bool:
    """Whether K2–K4 take operands of head dim ``d`` and these dtypes:
    each f32 or bf16 (they may differ: every operand is read in its own
    dtype), ``d % 8 == 0`` and ``d <= 1024``.  These are the JAX package's
    dtype and head-dim rules; the port has no platform, length or offset
    rule."""
    return (all(dt in _KERNEL_DTYPES for dt in dtypes) and d % 8 == 0
            and d <= 1024)


def fwd_instance(d: int, q_dtype: torch.dtype, k_dtype: torch.dtype,
                 v_dtype: torch.dtype) -> str:
    """Which instance of K2 takes a call, at every head dim the kernels
    take (``d <= 1024``; above 256 each runs its wide kernel): ``"wgmma"``
    when q, k and v are all bfloat16 (bf16 tensor cores), else, for any
    float32 operand, mixes included, ``"tf32x3"`` (tensor cores at f32
    accuracy).  Neither is a fallback for the other; no call picks the
    retired ``"simt"`` instance."""
    return "wgmma" if _all_bf16(q_dtype, k_dtype, v_dtype) else "tf32x3"


def bwd_instance(d: int, q_dtype: torch.dtype, k_dtype: torch.dtype,
                 v_dtype: torch.dtype, do_dtype: torch.dtype) -> str:
    """Which instance of K3 and K4 takes a call, at every head dim the
    kernels take (``d <= 1024``): ``"wgmma"`` when q, k, v and the
    cotangent dO are all bfloat16 (bf16 tensor cores), else ``"tf32x3"``
    (any float32 operand: tensor cores at f32 accuracy).  Above ``d =
    256`` each runs its wide kernels (the head dim streamed in slabs).
    Neither is a fallback for the other."""
    return ("wgmma" if _all_bf16(q_dtype, k_dtype, v_dtype, do_dtype)
            else "tf32x3")


def _all_bf16(*dtypes) -> bool:
    return all(dt == torch.bfloat16 for dt in dtypes)


def _fold(x: torch.Tensor) -> torch.Tensor:
    """``(S, H, *batch, D)`` -> ``(S, N, D)``, ``N = H * prod(batch)``."""
    return x.reshape(x.shape[0], -1, x.shape[-1])


def _score_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _offset(x) -> int:
    if isinstance(x, bool):
        raise TypeError("offsets are integers")
    return operator.index(x)


def _check_modes(q: torch.Tensor, partials: bool, return_stats: bool):
    if partials and q.dim() != 4:
        raise ValueError("partials mode expects the folded (S, H, B, D) "
                         "layout")
    if partials and return_stats:
        raise ValueError("partials already returns the statistics")


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and what the kernels are held to)
# ---------------------------------------------------------------------------

def stream_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool, q_offset: int = 0, kv_offset: int = 0,
                 chunk: Optional[int] = None,
                 score_dtype: torch.dtype = torch.float32,
                 p_dtype: Optional[torch.dtype] = None):
    """Flash statistics of folded ``q (Sq, N, D)`` against ``k, v (Skv, N,
    D)``, streaming ``chunk`` keys at a time: ``m, l`` of shape ``(N, Sq)``
    and ``acc`` of shape ``(Sq, N, D)``, in ``score_dtype``.  ``p_dtype``
    rounds the probabilities before ``P @ V`` (K2's bf16 rule).  Built
    from differentiable torch ops only (the JAX package's ``_flash_xla``
    and ``_flash_update``); chunks wholly above the causal diagonal are
    skipped, which changes only rows that see no key."""
    sq, n, d = q.shape
    skv = k.shape[0]
    scale = 1.0 / math.sqrt(d)
    neg = float(torch.finfo(score_dtype).min) / 2
    c = min(chunk or _DEF_CHUNK, max(skv, 1))
    qs = q.to(score_dtype).permute(1, 0, 2)                    # (N, Sq, D)
    rows = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((n, sq), neg, dtype=score_dtype, device=q.device)
    l = torch.zeros((n, sq), dtype=score_dtype, device=q.device)
    acc = torch.zeros((n, sq, d), dtype=score_dtype, device=q.device)
    for c0 in range(0, skv, c):
        if causal and q_offset + sq - 1 < kv_offset + c0:
            break
        kc = k[c0:c0 + c].to(score_dtype).permute(1, 0, 2)     # (N, C, D)
        vc = v[c0:c0 + c].to(score_dtype).permute(1, 0, 2)
        s = torch.matmul(qs, kc.transpose(1, 2)) * scale       # (N, Sq, C)
        if causal:
            cols = kv_offset + c0 + torch.arange(kc.shape[1],
                                                 device=q.device)
            s = torch.where(rows[:, None] >= cols[None, :], s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        if p_dtype is not None and p_dtype != score_dtype:
            p = p.to(p_dtype).to(score_dtype)
        acc = acc * corr[..., None] + torch.matmul(p, vc)
        m = m_new
    return m, l, acc.permute(1, 0, 2)


def normalize(l: torch.Tensor, acc: torch.Tensor, dtype) -> torch.Tensor:
    """``acc / l`` in ``dtype``, with ``l == 0 -> 1`` (a row that saw no
    key): ``l`` is ``(..., Sq)`` and ``acc`` is ``(Sq, ..., D)``."""
    l = torch.where(l == 0, torch.ones_like(l), l)
    return (acc / l.movedim(-1, 0)[..., None]).to(dtype)


def _unfold_partials(q, m, l, acc):
    sq, h, b, d = q.shape
    return (m.reshape(h, b, sq), l.reshape(h, b, sq),
            acc.reshape(sq, h, b, d))


def flash_attention_fwd_plain(q, k, v, *, causal: bool = False,
                              q_offset=0, kv_offset=0,
                              partials: bool = False,
                              return_stats: bool = False):
    """Plain version of K2, same arguments and output layouts."""
    _check_modes(q, partials, return_stats)
    m, l, acc = stream_stats(
        _fold(q), _fold(k), _fold(v), causal=causal,
        q_offset=_offset(q_offset), kv_offset=_offset(kv_offset),
        score_dtype=_score_dtype(q.dtype), p_dtype=v.dtype)
    if partials:
        return _unfold_partials(q, m, l, acc)
    out = normalize(l, acc, q.dtype).reshape(q.shape)
    return (out, (m, l)) if return_stats else out


def residuals(out: torch.Tensor, do: torch.Tensor, m: torch.Tensor,
              l: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row backward residuals from the forward's folded ``(m, l)``:
    the logsumexp ``L`` (+inf where ``l == 0``, so the rebuilt P is exactly
    0 there) and ``D = rowsum(dO * O)``, both ``(N, Sq)`` in at least
    float32."""
    sdt = _score_dtype(out.dtype)
    L = torch.where(l > 0, m + torch.log(l),
                    torch.full_like(m, float("inf")))
    D = (_fold(do).to(sdt) * _fold(out).to(sdt)).sum(dim=-1).t()
    return L, D.contiguous()


def _bwd_plain_folded(qf, kf, vf, dof, Lrow, Drow, *, causal, q_offset,
                      kv_offset):
    """The ``_bwd_common`` formulas per key block: folded f32 grads."""
    sq, n, d = qf.shape
    skv = kf.shape[0]
    scale = 1.0 / math.sqrt(d)
    sdt = _score_dtype(qf.dtype)
    c = min(_DEF_CHUNK, max(skv, 1))
    q = qf.to(sdt).permute(1, 0, 2)                            # (N, Sq, D)
    do = dof.to(sdt).permute(1, 0, 2)
    L = Lrow.to(sdt)[..., None]
    D = Drow.to(sdt)[..., None]
    rows = q_offset + torch.arange(sq, device=qf.device)
    dq = torch.zeros((n, sq, d), dtype=sdt, device=qf.device)
    dk = torch.zeros((n, skv, d), dtype=sdt, device=qf.device)
    dv = torch.zeros((n, skv, d), dtype=sdt, device=qf.device)
    for c0 in range(0, skv, c):
        if causal and q_offset + sq - 1 < kv_offset + c0:
            break
        k = kf[c0:c0 + c].to(sdt).permute(1, 0, 2)             # (N, C, D)
        v = vf[c0:c0 + c].to(sdt).permute(1, 0, 2)
        s = torch.matmul(q, k.transpose(1, 2)) * scale
        if causal:
            cols = kv_offset + c0 + torch.arange(k.shape[1],
                                                 device=qf.device)
            valid = rows[:, None] >= cols[None, :]
            s = torch.where(valid, s, NEG)
        p = torch.exp(s - L)
        if causal:
            p = torch.where(valid, p, 0.0)
        ds = p * (torch.matmul(do, v.transpose(1, 2)) - D)
        dq += torch.matmul(ds, k)
        dk[:, c0:c0 + c] = torch.matmul(ds.transpose(1, 2), q) * scale
        dv[:, c0:c0 + c] = torch.matmul(p.transpose(1, 2), do)
    return (dq.mul_(scale).permute(1, 0, 2), dk.permute(1, 0, 2),
            dv.permute(1, 0, 2))


def flash_attention_bwd_plain(q, k, v, out, do, m, l, *,
                              causal: bool = False, q_offset=0,
                              kv_offset=0):
    """Plain version of :func:`flash_attention_bwd`."""
    L, D = residuals(out, do, m, l)
    dq, dk, dv = _bwd_plain_folded(
        _fold(q), _fold(k), _fold(v), _fold(do), L, D, causal=causal,
        q_offset=_offset(q_offset), kv_offset=_offset(kv_offset))
    return (dq.to(q.dtype).reshape(q.shape), dk.to(k.dtype).reshape(k.shape),
            dv.to(v.dtype).reshape(v.shape))


def flash_attention_bwd_partials_plain(q, k, v, do, L, D, *,
                                       causal: bool = False, q_offset=0,
                                       kv_offset=0):
    """Plain version of :func:`flash_attention_bwd_partials`."""
    sq = q.shape[0]
    dq, dk, dv = _bwd_plain_folded(
        _fold(q), _fold(k), _fold(v), _fold(do), L.reshape(-1, sq),
        D.reshape(-1, sq), causal=causal, q_offset=_offset(q_offset),
        kv_offset=_offset(kv_offset))
    f32 = _score_dtype(q.dtype)
    return (dq.to(f32).reshape(q.shape), dk.to(f32).reshape(k.shape),
            dv.to(f32).reshape(v.shape))


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

_DT = {torch.float32: 0, torch.bfloat16: 1}   # DType in flash_common.cuh
_libs = {}
_ARGTYPES = {   # the C signatures of csrc/flash_fwd.cu, flash_bwd.cu and
    #               flash_bwd_tf32.cu
    "pa_flash_fwd_simt": "pppiiipipppiiiifillp",
    "pa_flash_fwd_wgmma": "ppppipppiiiifillp",
    "pa_flash_fwd_tf32x3": "pppiiipipppiiiifillp",
    "pa_flash_bwd_dq_wgmma": "pppppppiiiiifillp",
    "pa_flash_bwd_dkv_wgmma": "ppppppppiiiiifillp",
    "pa_flash_bwd_dq_tf32x3": "ppppiiiipppiiiiifillp",
    "pa_flash_bwd_dkv_tf32x3": "ppppiiiippppiiiiifillp",
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float,
           "l": ctypes.c_longlong}


def _fn(lib_name: str, fn_name: str):
    """A C entry point of a kernel library (built at first use), with its
    argument types set: ``c_void_p`` for every pointer and the stream."""
    from . import _build

    lib = _libs.get(lib_name)
    if lib is None:
        lib = _build.load(lib_name)
        _libs[lib_name] = lib
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = [_CTYPES[c] for c in _ARGTYPES[fn_name]]
        fn.restype = ctypes.c_int
    return fn


def _device(*tensors: torch.Tensor) -> str:
    """``"cpu"`` or ``"cuda"`` for tensors that share one device."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"flash attention: tensors on {dev} and "
                             f"{t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention: unsupported device {dev}")
    return dev.type


def _check_kernel(q, k, v, *extra):
    d = q.shape[-1]
    for name, t in (("q", q), ("k", k), ("v", v)) + extra:
        if t.dtype not in _KERNEL_DTYPES:
            raise TypeError(f"flash kernel: {name} is {t.dtype}; the kernels "
                            f"take float32 and bfloat16")
    if not supported(d):
        raise ValueError(f"flash kernel: head dim {d} is not a multiple of "
                         f"8 up to 1024")
    if k.shape[-1] != d or v.shape[-1] != d or k.shape[0] != v.shape[0]:
        raise ValueError("flash kernel: q/k/v head dims or k/v lengths "
                         "differ")
    n = _fold(q).shape[1]
    if _fold(k).shape[1] != n or _fold(v).shape[1] != n:
        raise ValueError("flash kernel: q/k/v head·batch extents differ")
    if n > _MAX_GRID_Y:
        raise ValueError(f"flash kernel: {n} head·batch slices exceed the "
                         f"grid limit {_MAX_GRID_Y}")
    return n, d


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it in a fresh allocation when its data does not
    start on the 16-byte boundary that K2's tile loads, the TMA loads of
    K3/K4's wgmma instance and the tile loads of their tf32x3 instance
    need."""
    global realigned_copies
    if t.data_ptr() % 16 == 0:
        return t
    realigned_copies += 1
    return t.clone(memory_format=torch.contiguous_format)


def launch_fwd(qf, kf, vf, out, acc, m, l, *, causal, q_offset, kv_offset,
               instance: Optional[str] = None):
    """One K2 launch on folded contiguous 16-byte-aligned ``(S, N, D)``
    operands, by the instance :func:`fwd_instance` picks (or ``instance``:
    ``"simt"`` launches the retired instance, ``d <= 256``), into the
    outputs given (``None``: not written): ``out`` ``(Sq, N, D)`` in f32 or
    bf16, ``acc`` ``(Sq, N, D)`` f32, ``m`` and ``l`` ``(N, Sq)`` f32.
    Above ``d = 256`` the tf32x3 instance reads f32 q, k and v: a bf16
    operand is widened to a fresh f32 tensor first, one pass each, and v's
    own dtype still decides the rounding of P."""
    global launches_fwd
    sq, n, d = qf.shape
    inst = instance or fwd_instance(d, qf.dtype, kf.dtype, vf.dtype)
    out_dt = _DT[out.dtype] if out is not None else 0
    tail = (_ptr(out), out_dt, _ptr(acc), _ptr(m), _ptr(l), n, sq,
            kf.shape[0], d, 1.0 / math.sqrt(d), int(causal), q_offset,
            kv_offset, _stream(qf))
    # `held` keeps the tensors the pointers name alive through the launch
    held = (qf, kf, vf)
    if inst == "wgmma":
        if not _all_bf16(qf.dtype, kf.dtype, vf.dtype):
            raise TypeError("flash forward: the wgmma instance takes bf16 "
                            "q, k and v")
        entry, head = "pa_flash_fwd_wgmma", ()
    elif inst in ("tf32x3", "simt"):
        if inst == "tf32x3" and d > 256:
            held = tuple(x.float() for x in held)
        entry = f"pa_flash_fwd_{inst}"
        head = (_DT[held[0].dtype], _DT[held[1].dtype], _DT[vf.dtype])
    else:
        raise ValueError(f"flash forward: no instance {inst!r}")
    with torch.cuda.device(qf.device):
        err = _fn("flash_fwd", entry)(*(_ptr(x) for x in held), *head,
                                      *tail)
    _raise_on(err, f"flash forward ({inst})")
    launches_fwd += 1
    launches_fwd_by_instance[inst] += 1


def _bwd_inst(qf, kf, vf, dof) -> str:
    return bwd_instance(qf.shape[-1], qf.dtype, kf.dtype, vf.dtype,
                        dof.dtype)


# C entry points of K3 and K4 by instance: (library, dq, dkv); the wgmma
# ones take no dtype flags (every operand is bf16)
_BWD_ENTRIES = {
    "wgmma": ("flash_bwd", "pa_flash_bwd_dq_wgmma", "pa_flash_bwd_dkv_wgmma"),
    "tf32x3": ("flash_bwd_tf32", "pa_flash_bwd_dq_tf32x3",
               "pa_flash_bwd_dkv_tf32x3"),
}


def _bwd_call(qf, kf, vf, dof, instance) -> Tuple[str, tuple, tuple]:
    """The instance of a K3/K4 launch (``instance``, else the one
    :func:`bwd_instance` picks), the operands the launch reads and its
    leading arguments, which point to them (hold the operands until the
    launch returns).  The tf32x3 instance's wide kernels (``d > 256``)
    load f32 tiles by TMA: a bf16 operand of such a call is widened to a
    fresh f32 tensor first, one pass each."""
    inst = instance or _bwd_inst(qf, kf, vf, dof)
    if inst not in _BWD_ENTRIES:
        raise ValueError(f"flash backward: no instance {inst!r}")
    ops = (qf, kf, vf, dof)
    if inst == "tf32x3" and qf.shape[-1] > 256:
        ops = tuple(x.float() for x in ops)
    head = tuple(_ptr(x) for x in ops)
    if inst != "wgmma":
        head += tuple(_DT[x.dtype] for x in ops)
    return inst, ops, head


def launch_dq(qf, kf, vf, dof, L, D, dq, *, causal, q_offset, kv_offset,
              instance: Optional[str] = None):
    """One K3 launch, by the instance :func:`bwd_instance` picks (or
    ``instance``, ``"wgmma"`` or ``"tf32x3"``): ``dq`` (folded
    ``(Sq, N, D)``, f32 or bf16) from folded contiguous operands (for the
    wgmma and tf32x3 instances starting on 16 bytes) and ``(N, Sq)`` f32
    residuals."""
    global launches_dq
    sq, n, d = qf.shape
    # `held` keeps the tensors `head` points to alive through the launch
    inst, held, head = _bwd_call(qf, kf, vf, dof, instance)
    lib, entry, _ = _BWD_ENTRIES[inst]
    with torch.cuda.device(qf.device):
        err = _fn(lib, entry)(
            *head, _ptr(L), _ptr(D), _ptr(dq), _DT[dq.dtype], n, sq,
            kf.shape[0], d, 1.0 / math.sqrt(d), int(causal), q_offset,
            kv_offset, _stream(qf))
    _raise_on(err, f"flash backward dq ({inst})")
    launches_dq += 1
    launches_dq_by_instance[inst] += 1


def launch_dkv(qf, kf, vf, dof, L, D, dk, dv, *, causal, q_offset,
               kv_offset, instance: Optional[str] = None):
    """One K4 launch, by the instance :func:`bwd_instance` picks (or
    ``instance``, as for :func:`launch_dq`): ``dk`` and ``dv`` (folded
    ``(Skv, N, D)``, one dtype) from folded contiguous operands (for the
    wgmma and tf32x3 instances starting on 16 bytes) and ``(N, Sq)`` f32
    residuals."""
    global launches_dkv
    sq, n, d = qf.shape
    if dk.dtype != dv.dtype:
        raise TypeError("flash backward: dk and dv must share a dtype")
    inst, held, head = _bwd_call(qf, kf, vf, dof, instance)
    lib, _, entry = _BWD_ENTRIES[inst]
    with torch.cuda.device(qf.device):
        err = _fn(lib, entry)(
            *head, _ptr(L), _ptr(D), _ptr(dk), _ptr(dv), _DT[dk.dtype], n,
            sq, kf.shape[0], d, 1.0 / math.sqrt(d), int(causal), q_offset,
            kv_offset, _stream(qf))
    _raise_on(err, f"flash backward dk/dv ({inst})")
    launches_dkv += 1
    launches_dkv_by_instance[inst] += 1


def flash_attention_fwd(q, k, v, *, causal: bool = False, q_offset=0,
                        kv_offset=0, partials: bool = False,
                        return_stats: bool = False):
    """Flash attention on ``(S, H, *batch, D)`` tensors (K2).

    Returns the normalized output (q's dtype and shape); with
    ``return_stats=True`` also the folded ``(m, l)``, each ``(N, Sq)`` f32:
    ``(out, (m, l))``; with ``partials=True`` (4-D ``(S, H, B, D)`` input)
    ``(m, l, acc)`` with ``m, l`` of shape ``(H, B, Sq)`` and ``acc`` of
    shape ``(Sq, H, B, D)``, all f32.  Offsets are Python ints."""
    _check_modes(q, partials, return_stats)
    q_offset, kv_offset = _offset(q_offset), _offset(kv_offset)
    if _device(q, k, v) == "cpu":
        return flash_attention_fwd_plain(
            q, k, v, causal=causal, q_offset=q_offset, kv_offset=kv_offset,
            partials=partials, return_stats=return_stats)
    n, d = _check_kernel(q, k, v)
    qf, kf, vf = (_aligned(_fold(x).contiguous()) for x in (q, k, v))
    sq = qf.shape[0]
    dev = q.device
    f32 = torch.float32
    out = acc = m = l = None
    if partials:
        acc = torch.empty((sq, n, d), dtype=f32, device=dev)
    else:
        out = torch.empty((sq, n, d), dtype=q.dtype, device=dev)
    if partials or return_stats:
        m = torch.empty((n, sq), dtype=f32, device=dev)
        l = torch.empty((n, sq), dtype=f32, device=dev)
    if sq and n and d:
        launch_fwd(qf, kf, vf, out, acc, m, l, causal=causal,
                   q_offset=q_offset, kv_offset=kv_offset)
    if partials:
        return _unfold_partials(q, m, l, acc)
    out = out.reshape(q.shape)
    return (out, (m, l)) if return_stats else out


def _bwd_kernels(qf, kf, vf, dof, L, D, dq_dtype, dkv_dtype, *, causal,
                 q_offset, kv_offset):
    sq, n, d = qf.shape
    skv = kf.shape[0]
    dev = qf.device
    qf, kf, vf, dof = (_aligned(x) for x in (qf, kf, vf, dof))
    dq = torch.empty((sq, n, d), dtype=dq_dtype, device=dev)
    dk = torch.empty((skv, n, d), dtype=dkv_dtype, device=dev)
    dv = torch.empty((skv, n, d), dtype=dkv_dtype, device=dev)
    if n and d:
        L = L.float().contiguous()
        D = D.float().contiguous()
        kw = dict(causal=causal, q_offset=q_offset, kv_offset=kv_offset)
        if sq:
            launch_dq(qf, kf, vf, dof, L, D, dq, **kw)
        if skv:
            launch_dkv(qf, kf, vf, dof, L, D, dk, dv, **kw)
    return dq, dk, dv


def flash_attention_bwd(q, k, v, out, do, m, l, *, causal: bool = False,
                        q_offset=0, kv_offset=0):
    """Flash-attention backward (K3 + K4): ``(dq, dk, dv)`` in the inputs'
    dtypes and shapes, from the forward's output and its folded ``(m, l)``
    (``return_stats=True``)."""
    q_offset, kv_offset = _offset(q_offset), _offset(kv_offset)
    if _device(q, k, v, out, do, m, l) == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, do, m, l,
                                         causal=causal, q_offset=q_offset,
                                         kv_offset=kv_offset)
    _check_kernel(q, k, v, ("do", do))
    L, D = residuals(out, do, m, l)
    # K4 writes dk and dv in one dtype: f32 where k and v differ
    dkv_dtype = k.dtype if k.dtype == v.dtype else torch.float32
    dq, dk, dv = _bwd_kernels(
        *(_fold(x).contiguous() for x in (q, k, v, do)), L, D, q.dtype,
        dkv_dtype, causal=causal, q_offset=q_offset, kv_offset=kv_offset)
    return (dq.reshape(q.shape), dk.to(k.dtype).reshape(k.shape),
            dv.to(v.dtype).reshape(v.shape))


def flash_attention_bwd_partials(q, k, v, do, L, D, *, causal: bool = False,
                                 q_offset=0, kv_offset=0):
    """Backward for ONE key block of a partials accumulation (K3 + K4)
    against the global residuals: ``q/k/v/do`` folded 4-D ``(S, H, B,
    D)``, ``L`` and ``D`` of shape ``(H, B, Sq)`` f32.  Returns ``(dq, dk,
    dv)`` in f32, ``(S, H, B, D)``."""
    q_offset, kv_offset = _offset(q_offset), _offset(kv_offset)
    if _device(q, k, v, do, L, D) == "cpu":
        return flash_attention_bwd_partials_plain(
            q, k, v, do, L, D, causal=causal, q_offset=q_offset,
            kv_offset=kv_offset)
    _check_kernel(q, k, v, ("do", do))
    sq = q.shape[0]
    f32 = torch.float32
    dq, dk, dv = _bwd_kernels(
        *(_fold(x).contiguous() for x in (q, k, v, do)), L.reshape(-1, sq),
        D.reshape(-1, sq), f32, f32, causal=causal, q_offset=q_offset,
        kv_offset=kv_offset)
    return dq.reshape(q.shape), dk.reshape(k.shape), dv.reshape(v.shape)
