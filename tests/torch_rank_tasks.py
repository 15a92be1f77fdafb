"""Functions the PyTorch-port tests run on every rank of a gloo pool.

Imported by the pool's rank processes, so it imports torch, NumPy and the
port only — never JAX.  Every function takes plain data (NumPy arrays,
tuples describing pencils) and returns NumPy results from rank 0 (``None``
from the other ranks).  Pencils are described as ``(decomp_dims, perm)``
with ``perm`` a tuple or ``None``.
"""

import os

import numpy as np
import torch

import pencilarrays_tpu_torch as pat
from pencilarrays_tpu_torch.ops import reductions
from pencilarrays_tpu_torch.interop import from_numpy_padded, to_numpy_padded
from pencilarrays_tpu_torch.models import (
    DiffusionSpectral,
    NavierStokesSpectral,
    taylor_green,
)

_TOPOLOGIES = {}


def topology(dims):
    """One CPU topology per dims per rank process (building one creates
    process sub-groups, which every rank must do in the same order)."""
    dims = tuple(dims)
    if dims not in _TOPOLOGIES:
        _TOPOLOGIES[dims] = pat.Topology(dims, device="cpu")
    return _TOPOLOGIES[dims]


def pencil(dims, shape, spec):
    decomp, perm = spec
    return pat.Pencil(topology(dims), shape, decomp,
                      permutation=None if perm is None
                      else pat.Permutation(*perm))


def _as_input(padded, bf16):
    t = torch.from_numpy(np.array(padded, copy=True))
    return t.view(torch.bfloat16) if bf16 else t


def _rank0(value):
    dist = torch.distributed
    return value if not dist.is_initialized() or dist.get_rank() == 0 \
        else None


def transpose_chain(dims, shape, extra, specs, padded, bf16=False,
                    method=None):
    """Load ``padded`` (the JAX package's ``.data`` on ``specs[0]``), hop
    through ``specs[1:]`` by ``method`` (default ``AllToAll()``) and
    return, for every pencil after the first, the padded global array,
    the gathered logical array, the masked global sum and every rank's
    exchange calls in that hop (``transpositions.exchange_calls``).  Odd
    hops go through the ``Transposition`` object API."""
    from pencilarrays_tpu_torch.parallel import transpositions as tr

    method = pat.AllToAll() if method is None else method
    pens = [pencil(dims, shape, s) for s in specs]
    x = from_numpy_padded(pens[0], _as_input(padded, bf16), extra)
    out = []
    for i, pen in enumerate(pens[1:]):
        for op in tr.exchange_calls:
            tr.exchange_calls[op] = 0
        if i % 2:
            t = pat.Transposition(pen, x, method=method)
            t.waitall()
            x = t.execute()
        else:
            x = pat.transpose(x, pen, method=method)
        calls = dict(tr.exchange_calls)
        everyone = [None] * torch.distributed.get_world_size()
        torch.distributed.all_gather_object(everyone, calls)
        total = reductions.sum(x.astype(torch.float64)
                               if bf16 else x).item()
        out.append((to_numpy_padded(x), pat.gather(x), total, everyone))
    return _rank0(out)


def _schedule(plan, N):
    """Step kinds, decompositions, memory orders, and a fused step's chunk
    dim and bounds."""
    return [(s[0], s[1].decomposition, tuple(s[1].permutation.apply(
        tuple(range(N)))), s[2].decomposition) + (
        (s[8], tuple(s[9])) if s[0] == "ft" else ()) for s in plan._steps]


def fft_case(dims, shape, kwargs, u, serial=False):
    """Forward and backward of a plan on the global input ``u``: the
    gathered spectrum, the gathered round trip, the schedule and the
    plan's collective costs; with ``serial``, also the spectrum of the
    same plan without ``pipeline`` and ``method`` (the serialized
    ``AllToAll`` schedule)."""
    plan = pat.PencilFFTPlan(topology(dims), shape, **kwargs)
    x = pat.PencilArray.from_global(plan.input_pencil, u)
    uh = plan.forward(x)
    back = plan.backward(uh)
    res = dict(spectrum=pat.gather(uh), back=pat.gather(back),
               schedule=_schedule(plan, len(shape)),
               costs=plan.collective_costs(),
               out_padded=to_numpy_padded(uh).shape,
               scale_factor=plan.scale_factor(),
               pipeline_chunks=plan.pipeline_chunks)
    if serial:
        plain = {k: v for k, v in kwargs.items()
                 if k not in ("pipeline", "method")}
        p0 = pat.PencilFFTPlan(topology(dims), shape, **plain)
        res["serial"] = pat.gather(p0.forward(
            pat.PencilArray.from_global(p0.input_pencil, u)))
    return _rank0(res)


def fft_grad_case(dims, shape, kwargs, padded):
    """Gradient of ``sum(|forward(x).data|^2)`` with respect to x's padded
    memory-order data (the JAX package's ``.data``), as the global padded
    array, for the plan of ``kwargs`` and for it without ``pipeline``."""
    out = []
    for kw in (kwargs, {k: v for k, v in kwargs.items()
                        if k != "pipeline"}):
        plan = pat.PencilFFTPlan(topology(dims), shape, **kw)
        x = from_numpy_padded(plan.input_pencil, padded)
        leaf = x.data.clone().requires_grad_()
        uh = plan.forward(pat.PencilArray(plan.input_pencil, leaf))
        (uh.data.abs() ** 2).sum().backward()
        out.append(to_numpy_padded(pat.PencilArray(plan.input_pencil,
                                                   leaf.grad)))
    return _rank0(out)


def spectral_case(dims, n, dtype, uh0_padded, dt, nu):
    """From the JAX package's Taylor–Green state: the port's own
    Taylor–Green state, two RK2 steps, one RK4 step (all gathered in
    logical order) and the energies after each."""
    dtype = getattr(torch, dtype)
    model = NavierStokesSpectral(topology(dims), n, viscosity=nu,
                                 dtype=dtype)
    uh0 = from_numpy_padded(model.plan.output_pencil, uh0_padded, (3,))
    own = taylor_green(model)
    s = model.step(model.step(uh0, dt), dt)
    r4 = model.step_rk4(uh0, dt)
    return _rank0(dict(own=pat.gather(own), rk2=pat.gather(s),
                       rk4=pat.gather(r4),
                       energy=[float(model.energy(v)) for v in (uh0, s, r4)]))


def simulate_case(dims, n, dtype, uh0_padded, dt, nu, n_steps, rk4=False):
    """``simulate`` from the JAX package's Taylor–Green state: the final
    state (gathered) and the per-step energies, and the same number of
    ``step`` calls."""
    dtype = getattr(torch, dtype)
    model = NavierStokesSpectral(topology(dims), n, viscosity=nu,
                                 dtype=dtype)
    uh0 = from_numpy_padded(model.plan.output_pencil, uh0_padded, (3,))
    stepper = model.step_rk4 if rk4 else None
    final, energies = model.simulate(uh0, dt, n_steps, record_energy=True,
                                     stepper=stepper)
    none = model.simulate(uh0, dt, 1, stepper=stepper)[1]
    s = uh0
    for _ in range(n_steps):
        s = (stepper or model.step)(s, dt)
    return _rank0(dict(final=pat.gather(final), steps=pat.gather(s),
                       energies=energies.cpu().numpy(),
                       energy_device=str(energies.device), none=none))


def diffusion_case(dims, n, u0, t, kappa):
    """The port's exact diffusion solve of the global field ``u0``."""
    model = DiffusionSpectral(topology(dims), n, kappa=kappa,
                              dtype=torch.float64)
    x = pat.PencilArray.from_global(model.plan.input_pencil, u0)
    return _rank0(pat.gather(model.solve(x, t)))


def attention_case(P, scheme, causal, impl, q, k, v, ct, bf16=False):
    """``scheme`` in ("ulysses", "ring", "zigzag") on a (P,) topology of
    the global (S, H, *batch, D) inputs; ``zigzag`` moves them to zigzag
    placement first (``ct`` is given in that placement).  Returns the
    gathered output and q/k/v gradients of ``sum(out * ct)``, and for
    zigzag the gathered zigzag inputs and the round trip back."""
    from pencilarrays_tpu_torch.models import attention as A

    topo = topology((P,))
    pen = pat.Pencil(topo, q.shape[:2], (0,))
    extra = q.shape[2:]
    dt = torch.bfloat16 if bf16 else torch.float32
    arrs = [pat.PencilArray.from_global(pen, x).astype(dt) for x in (q, k, v)]
    res = {}
    if scheme == "zigzag":
        zz = [A.to_zigzag(x) for x in arrs]
        res["zigzag_in"] = [pat.gather(x) for x in zz]
        res["round_trip"] = [pat.gather(A.from_zigzag(x)) for x in zz]
        arrs = zz
    leaves = [pat.PencilArray(pen, x.data.clone().requires_grad_(), extra)
              for x in arrs]
    if scheme == "ulysses":
        out = A.ulysses_attention(*leaves, causal=causal, impl=impl)
    else:
        out = A.ring_attention(*leaves, causal=causal,
                               zigzag=scheme == "zigzag", impl=impl)
    ctl = pat.PencilArray.from_global(pen, ct).data.to(dt)
    (out.data.float() * ctl.float()).sum().backward()
    res["out"] = pat.gather(out)
    res["grads"] = [pat.gather(pat.PencilArray(pen, x.data.grad, extra))
                    for x in leaves]
    return _rank0(res)


def ring_cotangent_case(P, zigzag, q, k, v, ct):
    """bf16 causal ring attention (naive, or zigzag for P > 1) on the
    kernel path, its backward run twice with ``flash_attention_bwd_partials``
    wrapped by a spy: once passing each call's result through, once
    returning the same call made with the cotangent widened to f32.
    Returns the dtype the cotangent reached each call in, whether each
    call's grads equal those of the widened call bit for bit, and whether
    the two backwards' q/k/v grads are bit-identical."""
    from pencilarrays_tpu_torch.models import attention as A
    from pencilarrays_tpu_torch.ops import flash

    topo = topology((P,))
    pen = pat.Pencil(topo, q.shape[:2], (0,))
    extra = q.shape[2:]
    bf16 = torch.bfloat16
    arrs = [pat.PencilArray.from_global(pen, x).astype(bf16)
            for x in (q, k, v)]
    ctl = pat.PencilArray.from_global(pen, ct).data.to(bf16).float()
    if zigzag:
        arrs = [A.to_zigzag(x) for x in arrs]
    orig = flash.flash_attention_bwd_partials
    calls = []

    def grads(widen):
        def spy(qb, kb, vb, do, L, D, **kw):
            got = orig(qb, kb, vb, do, L, D, **kw)
            wide = orig(qb, kb, vb, do.float(), L, D, **kw)
            calls.append((str(do.dtype), all(
                torch.equal(a, b) for a, b in zip(got, wide))))
            return wide if widen else got

        leaves = [pat.PencilArray(pen, x.data.clone().requires_grad_(), extra)
                  for x in arrs]
        flash.flash_attention_bwd_partials = spy
        try:
            out = A.ring_attention(*leaves, causal=True, zigzag=zigzag,
                                   impl="kernel")
            (out.data.float() * ctl).sum().backward()
        finally:
            flash.flash_attention_bwd_partials = orig
        return [x.data.grad for x in leaves]

    got, wide = grads(False), grads(True)
    return _rank0(dict(
        calls=calls, grad_dtypes=[str(g.dtype) for g in got],
        same=all(torch.equal(a, b) for a, b in zip(got, wide))))


def hop_grad_case(dims, shape, extra, specs, padded, ct_padded,
                  method=None):
    """Gradient of ``sum(transpose(x, specs[1]).data * ct)`` with respect
    to x's padded memory-order data, as the global padded array (the
    JAX package's ``.data`` layout); the hop by ``method`` (default
    ``AllToAll()``)."""
    method = pat.AllToAll() if method is None else method
    pin, pout = (pencil(dims, shape, s) for s in specs)
    x = from_numpy_padded(pin, padded, extra)
    leaf = x.data.clone().requires_grad_()
    y = pat.transpose(pat.PencilArray(pin, leaf, x.extra_dims), pout,
                      method=method)
    ct = from_numpy_padded(pout, ct_padded, extra).data
    (y.data * ct).sum().backward()
    return _rank0(to_numpy_padded(pat.PencilArray(pin, leaf.grad,
                                                  x.extra_dims)))


# -- the grid toolbox and the halo-exchange path ---------------------------
# One pool of 8 ranks serves topologies of 1, 2, 4 and 8 ranks: each is
# built over the first ranks of the pool, and the others mirror its
# sub-group creation (``new_group`` is collective over the whole pool).

_SUB = {}
_SHARED = {}


def shared_pool(n=8):
    """One pool of ``n`` gloo ranks per test process, kept until the
    process exits."""
    import atexit

    from pencilarrays_tpu_torch.parallel.distributed import RankPool

    if n not in _SHARED:
        _SHARED[n] = RankPool(n)
        atexit.register(_SHARED[n].close)
    return _SHARED[n]


def sub_topology(dims):
    """A CPU topology over the first ``prod(dims)`` ranks of the pool;
    ``None`` on the other ranks.  Every rank of the pool calls it."""
    import math

    from pencilarrays_tpu_torch.parallel.topology import axis_lines

    dims = tuple(dims)
    if dims not in _SUB:
        dist = torch.distributed
        n = math.prod(dims)
        if n == dist.get_world_size():
            _SUB[dims] = pat.Topology(dims, device="cpu")
        else:
            group = dist.new_group(list(range(n)))
            if dist.get_rank() < n:
                _SUB[dims] = pat.Topology(dims, device="cpu", group=group)
            else:
                for axis in range(len(dims)):
                    for line in axis_lines(dims, axis):
                        dist.new_group(list(line))
                _SUB[dims] = None
    return _SUB[dims]


def _sub_pencil(topo, shape, decomp, perm):
    return pat.Pencil(topo, shape, decomp, permutation=None if perm is None
                      else pat.Permutation(*perm))


def _np(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _calls(fn, *args):
    """``fn(*args)`` with ``halo_exchange`` counted from 0; returns the
    result and every rank's counts (rank order)."""
    from pencilarrays_tpu_torch.ops import stencil

    for k in stencil.halo_exchange:
        stencil.halo_exchange[k] = 0
    out = fn(*args)
    counts = dict(stencil.halo_exchange)
    everyone = [None] * torch.distributed.get_world_size(
        pat_group(args[0]))
    torch.distributed.all_gather_object(everyone, counts,
                                        group=pat_group(args[0]))
    return out, everyone


def pat_group(x):
    return x.pencil.topology.group


def arrays_case(dims, shape, decomp, perm, u, keys, extra=0):
    """Global views of ``u`` (logical, NumPy) on the sub-topology: every
    rank's answer to each global index of ``keys``, ``logical()``,
    ``np.asarray``, every block by ``local_block`` (logical and memory
    order) and the padded memory-order data (the JAX package's
    ``.data`` layout)."""
    topo = sub_topology(dims)
    if topo is None:
        return None
    pen = _sub_pencil(topo, shape, decomp, perm)
    x = pat.PencilArray.from_global(pen, u, extra)
    items = [_np(x[k]) for k in keys]
    everyone = [None] * len(topo)
    torch.distributed.all_gather_object(everyone, items, group=topo.group)
    blocks = {}
    for r in range(len(topo)):
        c = topo.coords(r)
        blocks[c] = (_np(x.local_block(c)),
                     _np(x.local_block(c, pat.MemoryOrder)))
    own = _np(x.local_block())
    return _rank0(dict(items=everyone, logical=_np(x.logical()),
                       array=np.asarray(x), blocks=blocks, own=own,
                       padded=to_numpy_padded(x)))


def protocols_case(dims, shape, decomp, perm, u, v, raw):
    """The NumPy protocols, ``pnp``, the elementwise methods and the
    comparisons on the sub-topology: each array result gathered and as
    the padded global array, and each value."""
    import pencilarrays_tpu_torch.numpy as pnp

    topo = sub_topology(dims)
    if topo is None:
        return None
    pen = _sub_pencil(topo, shape, decomp, perm)
    x = pat.PencilArray.from_global(pen, u)
    y = pat.PencilArray.from_global(pen, v)
    poisoned = (x + 100.0) - 100.0
    res = dict(
        cos=np.cos(x), add=np.add(x, y), arctan2=np.arctan2(x, y),
        raw_left=np.add(raw, x), infix=x * raw + x * raw[0, 0],
        scalar=(x + 1.0) / 2.0, map=x.map(torch.sin),
        pnp_cos=pnp.cos(x), pnp_mul=pnp.multiply(x, raw[0, 0]),
        pnp_where=pnp.where(pnp.greater(x, 0), x, 0.0),
        fill=x.fill(3.0),
        full=pat.PencilArray.full(pen, 2.5, dtype=torch.float64),
        conj=(x * 1j).conj(), real=(x * 1j).real, imag=(x * 1j).imag,
        copy=x.copy())
    out = {k: (pat.gather(a), to_numpy_padded(a)) for k, a in res.items()}
    out.update(
        np_sum=float(np.sum(poisoned)), np_max=float(np.max(poisoned)),
        np_mean=float(np.mean(poisoned)), np_min=float(np.min(poisoned)),
        eq_self=x == x, eq_other=x == y, eq_padded=(x + 1.0) == (
            pat.PencilArray.from_global(pen, u + 1.0)),
        allclose=poisoned.allclose(x), equals=bool(x.equals(x.copy())),
        sizeof=x.sizeof_global(), length=len(x))
    return _rank0(out)


def reductions_case(dims, shape, decomp, perm, arrays, nan_padding=True):
    """Every reduction over the global arrays ``arrays`` (name -> NumPy,
    logical order) on the sub-topology, with NaN written into the tail
    padding first so that only masking keeps it out."""
    from pencilarrays_tpu_torch.ops import reductions as R

    topo = sub_topology(dims)
    if topo is None:
        return None
    pen = _sub_pencil(topo, shape, decomp, perm)
    xs = {}
    for name, a in arrays.items():
        x = pat.PencilArray.from_global(pen, a)
        if nan_padding and (x.dtype.is_floating_point or x.dtype.is_complex):
            mask = R._valid_mask(x)
            if mask is not None:
                x = pat.PencilArray(pen, torch.where(
                    mask, x.data, torch.full((), float("nan"),
                                             dtype=x.dtype)))
        xs[name] = x
    out = {}
    for name, x in xs.items():
        r = {}
        if not x.dtype.is_complex:
            r.update(min=R.minimum(x), max=R.maximum(x))
        if x.dtype != torch.bool:
            r.update(sum=R.sum(x), prod=R.prod(x), mean=R.mean(x),
                     norm2=R.norm(x), norm1=R.norm(x, 1),
                     norminf=R.norm(x, float("inf")), norm3=R.norm(x, 3),
                     dot=R.dot(x, x), count=R.count_nonzero(x))
        r.update(any=R.any(x), all=R.all(x),
                 any_pos=R.any(x, pred=lambda d: d.real > 0.5),
                 all_fin=R.all(x, pred=torch.isfinite))
        out[name] = {k: _np(v) for k, v in r.items()}
    if "u" in xs and "v" in xs:
        out["dot_uv"] = _np(R.dot(xs["u"], xs["v"]))
        out["zipped"] = _np(R.mapreduce(lambda a, b: a * b, torch.sum,
                                        xs["u"], xs["v"], identity=0))
    return _rank0(out)


def localgrid_case(dims, shape, decomp, perm, coords, u):
    """``localgrid`` on the sub-topology: every rank's components
    (padded, memory order, exactly), ``evaluate``, ``zip_with`` and
    ``meshgrid`` as padded global arrays, and the grid walk."""
    topo = sub_topology(dims)
    if topo is None:
        return None
    pen = _sub_pencil(topo, shape, decomp, perm)
    g = pat.localgrid(pen, coords)
    x = pat.PencilArray.from_global(pen, u)
    comps = [_np(c) for c in g.components()]
    everyone = [None] * len(topo)
    torch.distributed.all_gather_object(everyone, comps, group=topo.group)
    names = [_np(getattr(g, "xyz"[d])) for d in range(pen.ndims)]
    ev = g.evaluate(lambda a, b, c: a + 2 * b * torch.cos(c))
    ev3 = g.evaluate(lambda a, b, c: a + b + c, extra_dims=(3,))
    zw = g.zip_with(lambda v, a, b, c: v + a + 2.0 * b * torch.cos(c), x)
    mesh = [to_numpy_padded(pat.PencilArray(pen, m)) for m in g.meshgrid()]
    return _rank0(dict(components=everyone, names=names,
                       evaluate=to_numpy_padded(ev),
                       evaluate3=to_numpy_padded(ev3),
                       zip_with=to_numpy_padded(zw), meshgrid=mesh,
                       walk=list(g), length=len(g)))


def stencil_case(dims, shape, decomp, perm, u, ops_list):
    """Each ``(name, args, kwargs)`` of ``ops_list`` (``shift``, ``diff``,
    ``fd_laplacian``, ``fd_gradient``, ``fd_divergence_of_gradient``)
    applied to the global logical field on the sub-topology: each result
    as ``(padded global array, gathered)``, and every rank's halo counts."""
    from pencilarrays_tpu_torch.ops import stencil as S

    topo = sub_topology(dims)
    if topo is None:
        return None
    pen = _sub_pencil(topo, shape, decomp, perm)
    x = pat.PencilArray.from_global(pen, u)
    out = []
    for name, args, kw in ops_list:
        if name == "fd_divergence_of_gradient":
            fn = lambda a: S.fd_divergence(S.fd_gradient(a, **kw), **kw)
        elif name == "fd_gradient":
            fn = lambda a: S.fd_gradient(a, **kw)
        else:
            fn = lambda a: getattr(S, name)(a, *args, **kw)
        res, counts = _calls(fn, x)
        res = [(to_numpy_padded(r), pat.gather(r)) for r in res] \
            if isinstance(res, tuple) else (to_numpy_padded(res),
                                             pat.gather(res))
        out.append((res, counts))
    return _rank0(out)


def stencil_grad_case(dims, shape, decomp, perm, u, spacing):
    """Gradient of ``sum(fd_laplacian(x)^2)`` with respect to x's padded
    data, as ``(padded global array, gathered)``."""
    from pencilarrays_tpu_torch.ops import stencil as S

    topo = sub_topology(dims)
    if topo is None:
        return None
    pen = _sub_pencil(topo, shape, decomp, perm)
    x = pat.PencilArray.from_global(pen, u)
    leaf = x.data.clone().requires_grad_()
    w = S.fd_laplacian(pat.PencilArray(pen, leaf), spacing=spacing)
    (w.data ** 2).sum().backward()
    grad = pat.PencilArray(pen, leaf.grad)
    return _rank0((to_numpy_padded(grad), pat.gather(grad)))


def heat_case(dims, shape, decomp, g, kappa, steps, boundary="periodic",
              dtype="float64"):
    """``HeatFD`` from the global field ``g``: the gathered state after
    each of ``steps`` steps at ``stable_dt``, norms before and after, and
    every rank's exchange counts (halo and all-to-all) over the steps."""
    from pencilarrays_tpu_torch.models import HeatFD
    from pencilarrays_tpu_torch.ops import reductions as R
    from pencilarrays_tpu_torch.parallel import transpositions as tr

    topo = sub_topology(dims)
    if topo is None:
        return None
    m = HeatFD(topo, shape, kappa=kappa, decomp_dims=decomp,
               boundary=boundary, dtype=getattr(torch, dtype))
    u = m.from_global(g)
    e0 = float(R.norm(u))
    for op in tr.exchange_calls:
        tr.exchange_calls[op] = 0
    states = []

    def run(v):
        for _ in range(steps):
            v = m.step(v, m.stable_dt())
            states.append(pat.gather(v))
        return v

    u, counts = _calls(run, u)
    a2a = [None] * len(topo)
    torch.distributed.all_gather_object(a2a, dict(tr.exchange_calls),
                                        group=topo.group)
    return _rank0(dict(states=states, e0=e0, e1=float(R.norm(u)),
                       finite=bool(R.all(u, pred=torch.isfinite)),
                       halo=counts, exchange=a2a, dt=m.stable_dt(),
                       spacing=m.spacing))


def ode_case(dims, shape, decomp, u0, problem, kwargs, dtype):
    """``integrate`` of one of the JAX package's ``test_ode_*`` problems
    from the global field ``u0``: the gathered solution and every rank's
    stats."""
    from pencilarrays_tpu_torch.models import integrate

    topo = sub_topology(dims)
    if topo is None:
        return None
    pen = pat.Pencil(topo, shape, decomp)
    x = pat.PencilArray.from_global(pen, u0).astype(getattr(torch, dtype))
    f = {"decay": lambda t, u: u.map(lambda d: -1.7 * d),
         "blowup": lambda t, u: u.map(lambda d: d * d * d * 10.0),
         "stiff": lambda t, u: u.map(lambda d: -1e8 * d),
         "unit": lambda t, u: u.map(lambda d: -d),
         "nan": lambda t, u: u.map(lambda d: -d)}[problem]
    u, stats = integrate(f, x, **kwargs)
    mine = dict(t=float(stats["t"]), dt=float(stats["dt"]),
                t_dtype=str(np.asarray(stats["t"]).dtype),
                n_accepted=stats["n_accepted"],
                n_rejected=stats["n_rejected"],
                nan_detected=stats["nan_detected"])
    everyone = [None] * len(topo)
    torch.distributed.all_gather_object(everyone, mine, group=topo.group)
    return _rank0(dict(u=pat.gather(u), stats=everyone))


def wrms_case(dims, shape, decomp, u, aux):
    """``global_wrms_norm`` of ``u`` (padding poisoned by scalar
    arithmetic) alone and beside plain auxiliaries."""
    from pencilarrays_tpu_torch.interop import global_wrms_norm

    topo = sub_topology(dims)
    if topo is None:
        return None
    x = pat.PencilArray.from_global(pat.Pencil(topo, shape, decomp), u)
    x = (x + 7.0) - 7.0
    return _rank0(dict(alone=float(global_wrms_norm(x)),
                       mixed=float(global_wrms_norm(
                           {"field": x, "aux": torch.tensor(aux)})),
                       seq=float(global_wrms_norm([x, [x]]))))


def random_case(dims, shape, decomp, perm, seed, extra=()):
    """``uniform`` and ``normal`` (float32, float64, complex64) fills on the
    sub-topology, gathered, and the padded data of one (padding zero)."""
    from pencilarrays_tpu_torch.ops import random as Rnd

    topo = sub_topology(dims)
    if topo is None:
        return None
    pen = _sub_pencil(topo, shape, decomp, perm)
    u32 = Rnd.uniform(pen, seed, extra)
    out = dict(u32=pat.gather(u32), padded=to_numpy_padded(u32),
               u64=pat.gather(Rnd.uniform(pen, seed, extra, torch.float64)),
               n32=pat.gather(Rnd.normal(pen, seed, extra)),
               n64=pat.gather(Rnd.normal(pen, seed, extra, torch.float64)),
               c64=pat.gather(Rnd.normal(pen, seed, extra, torch.complex64)))
    return _rank0(out)


def spectral_ops_case(dims, shape, fields, vec, lengths):
    """The spectral operators on a float64 r2c plan of the sub-topology,
    from the physical global fields: every result transformed back and
    gathered (components in the trailing dim)."""
    from pencilarrays_tpu_torch import ops

    topo = sub_topology(dims)
    if topo is None:
        return None
    plan = pat.PencilFFTPlan(topo, shape, real=True, dtype=torch.float64)

    def fwd(f):
        return plan.forward(pat.PencilArray.from_global(plan.input_pencil, f))

    def back(v):
        if not v.extra_dims:
            return pat.gather(plan.backward(v))
        comps = v.unstack()
        return np.stack([back(c) for c in comps], axis=-1)

    fh = fwd(fields[0])
    uh = pat.PencilArray.stack([fwd(c) for c in vec])
    batch = pat.PencilArray.stack([fwd(f) for f in fields])
    out = dict(
        grad=back(ops.gradient(plan, fh)),
        grad_L=back(ops.gradient(plan, fh, lengths=lengths)),
        div_grad=back(ops.divergence(plan, ops.gradient(plan, fh))),
        lap=back(ops.laplacian(plan, fh)),
        curl=back(ops.curl(plan, uh)),
        curl_grad=back(ops.curl(plan, ops.gradient(plan, fh))),
        poisson=back(ops.solve_poisson(plan, fh)),
        lap_vec=back(ops.laplacian(plan, uh)),
        poisson_vec=back(ops.solve_poisson(plan, ops.laplacian(plan, uh))),
        grad_batch=back(ops.gradient(plan, batch)),
        grad_padded=to_numpy_padded(ops.gradient(plan, fh)))
    return _rank0(out)


def multiarrays_case(dims, shape, specs, u):
    """A ``ManyPencilArray`` over ``specs`` from the global field ``u``:
    the padded data after each hop of two cycles and a walk back, and
    whether donation deleted the sources."""
    topo = sub_topology(dims)
    if topo is None:
        return None
    pens = [_sub_pencil(topo, shape, d, p) for d, p in specs]
    A = pat.ManyPencilArray(*pens, dtype=torch.float64)
    x0 = pat.PencilArray.from_global(pens[0], u)
    A.set(x0)
    seen = []
    for _ in range(2):
        for arr in A.cycle():
            seen.append((arr.pencil.decomposition, to_numpy_padded(arr)))
    kept = A.current
    A.transpose_to(0, donate=False)
    back = to_numpy_padded(A.current)
    A.transpose_to(1)
    return _rank0(dict(seen=seen, back=back, x0_deleted=x0.is_deleted(),
                       kept_deleted=kept.is_deleted(),
                       first_ok=A.index == 1))


# -- wire formats, Gspmd and the reshard route planner ---------------------


def _exchange_counts():
    from pencilarrays_tpu_torch.parallel import transpositions as tr

    return dict(tr.exchange_calls), dict(tr.exchange_bytes)


def _reset_exchange_counts():
    from pencilarrays_tpu_torch.parallel import transpositions as tr

    for table in (tr.exchange_calls, tr.exchange_bytes):
        for op in table:
            table[op] = 0


def wired_chain_case(dims, shape, specs, u, method):
    """Hop the global field ``u`` through ``specs`` by ``method`` (wired):
    for every pencil after the first, the padded global array, the
    gathered array, and every rank's exchange calls and bytes."""
    topo = sub_topology(dims)
    if topo is None:
        return None
    pens = [_sub_pencil(topo, shape, d, p) for d, p in specs]
    x = pat.PencilArray.from_global(pens[0], u)
    out = []
    for pen in pens[1:]:
        _reset_exchange_counts()
        x = pat.transpose(x, pen, method=method)
        everyone = [None] * len(topo)
        torch.distributed.all_gather_object(everyone, _exchange_counts(),
                                            group=topo.group)
        out.append((to_numpy_padded(x), pat.gather(x), everyone))
    return _rank0(out)


def wired_grad_case(dims, shape, specs, u, method):
    """The error a gradient through a wired hop raises."""
    topo = sub_topology(dims)
    if topo is None:
        return None
    pin, pout = (_sub_pencil(topo, shape, d, p) for d, p in specs)
    x = pat.PencilArray.from_global(pin, u)
    leaf = pat.PencilArray(pin, x.data.clone().requires_grad_())
    try:
        pat.transpose(leaf, pout, method=method)
    except RuntimeError as e:
        return _rank0(str(e))
    return _rank0("no error")


def reshard_case(dims, shape, src_spec, dest_spec, u, runs):
    """``reshard`` of the global field ``u`` from ``src_spec`` to
    ``dest_spec`` once per ``(kwargs, donate)`` of ``runs``: the padded
    global result, the route's verdict and hops, every rank's exchange
    calls, whether the source was deleted, or the error's type and
    message."""
    from pencilarrays_tpu_torch.parallel import routing

    topo = sub_topology(dims)
    if topo is None:
        return None
    pin = _sub_pencil(topo, shape, *src_spec)
    dest = _sub_pencil(topo, shape, *dest_spec)
    res = []
    for kwargs in runs:
        x = pat.PencilArray.from_global(pin, u)
        _reset_exchange_counts()
        try:
            y = pat.reshard(x, dest, **kwargs)
        except Exception as e:  # noqa: BLE001 - the test checks the type
            res.append(dict(error=(type(e).__name__, str(e))))
            continue
        calls = [None] * len(topo)
        torch.distributed.all_gather_object(calls, _exchange_counts(),
                                            group=topo.group)
        plan_kw = {k: v for k, v in kwargs.items()
                   if k in ("method", "hbm_limit", "donate")}
        route = (None if isinstance(kwargs.get("method"), pat.Gspmd) else
                 routing.plan_reshard_route(pin, dest, (), x.dtype
                                            if not x.is_deleted() else
                                            torch.float64, **plan_kw))
        res.append(dict(
            padded=to_numpy_padded(y), glob=pat.gather(y), calls=calls,
            deleted=x.is_deleted(),
            verdict=None if route is None else route.verdict,
            hops=None if route is None else [
                (h.dest.decomposition, type(h.method).__name__)
                for h in route.hops]))
    return _rank0(res)


def fft_wire_case(dims, shape, kwargs, u, variants=()):
    """A plan of ``kwargs`` on the global input ``u``: gathered spectrum
    and round trip, schedule, costs, plan key, decomposition verdict,
    and for each wire of ``variants`` the spectrum of
    ``with_wire_dtype(wire)`` and its key."""
    topo = sub_topology(dims)
    if topo is None:
        return None
    plan = pat.PencilFFTPlan(topo, shape, **kwargs)
    x = pat.PencilArray.from_global(plan.input_pencil, u)
    uh = plan.forward(x)
    res = dict(spectrum=pat.gather(uh), back=pat.gather(plan.backward(uh)),
               schedule=_schedule(plan, len(shape)),
               methods=[type(s[4]).__name__ + str(s[4].chunks)
                        for s in plan._steps if s[0] == "t" and len(s) > 4],
               costs=plan.collective_costs(), key=plan.plan_key(),
               topo=plan.topology.dims,
               verdict=plan.decomposition_verdict, variants={})
    for w in variants:
        v = plan.with_wire_dtype(w)
        res["variants"][w] = (pat.gather(v.forward(
            pat.PencilArray.from_global(v.input_pencil, u))), v.plan_key())
    return _rank0(res)


def spectral_wire_case(dims, n, dtype, uh0_padded_logical, dt, nu, kwargs):
    """Two RK2 steps of the NS model built with ``kwargs`` (``wire_dtype``,
    ``decomposition``) from the global spectral state (logical order)."""
    topo = sub_topology(dims)
    if topo is None:
        return None
    model = NavierStokesSpectral(topo, n, viscosity=nu,
                                 dtype=getattr(torch, dtype), **kwargs)
    uh0 = pat.PencilArray.from_global(model.plan.output_pencil,
                                      uh0_padded_logical)
    s = model.step(model.step(uh0, dt), dt)
    return _rank0(dict(rk2=pat.gather(s), topo=model.plan.topology.dims,
                       energy=float(model.energy(s))))


def reshard_to_case(dims, shape, specs, u):
    """``ManyPencilArray.reshard_to`` from the first to the last pencil of
    ``specs`` and the hop-by-hop ``transpose_to``: both padded results."""
    topo = sub_topology(dims)
    if topo is None:
        return None
    pens = [_sub_pencil(topo, shape, d, p) for d, p in specs]
    out = []
    for jump in (True, False):
        A = pat.ManyPencilArray(*pens, first=pat.PencilArray.from_global(
            pens[0], u))
        if jump:
            A.reshard_to(len(pens) - 1, donate=False)
        else:
            A.transpose_to(len(pens) - 1, donate=False)
        out.append((A.index, to_numpy_padded(A.current)))
    return _rank0(out)


# -- parallel I/O and checkpoints (tests/test_torch_io.py,
# tests/test_torch_resilience.py) ------------------------------------------

IO_SHAPE = (11, 13, 10)
IO_WRITER = ((1, 2), (2, 0, 1))    # the JAX tests' fixture pencil
IO_READER = ((0, 1), (1, 2, 0))


def _io_data(shape, extra=(), seed=0, dtype="float64"):
    u = np.random.default_rng(seed).standard_normal(tuple(shape) + extra)
    return u.astype(dtype)


def _io_array(topo, spec, u, shape=IO_SHAPE):
    pen = _sub_pencil(topo, shape, *spec)
    return pen, pat.PencilArray.from_global(pen, u, u.ndim - len(shape))


def _barrier(topo, name):
    from pencilarrays_tpu_torch.parallel.distributed import \
        sync_global_devices

    sync_global_devices(name, topo.group)


def _same(a, b):
    """Bit identity of two NumPy arrays (dtype included)."""
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def _check_gathered(x, u):
    g = pat.gather(x)
    if g is not None:
        _same(g, u)


def _io_open(path, topo, driver=None, **mode):
    from pencilarrays_tpu_torch.io import BinaryDriver, open_file

    return open_file(driver or BinaryDriver(), path, comm=topo.group, **mode)


def io_case(dims, case, tmp, *args):
    """Run the I/O case ``case`` of ``_IO_CASES`` on a CPU topology of
    ``dims`` (and the 1-D topology of as many ranks) over the pool's first
    ranks, files under ``tmp``; the case asserts on every rank and returns
    rank 0's result."""
    import math

    topo = sub_topology(dims)
    flat = sub_topology((math.prod(dims),))
    if topo is None:
        return None
    return _rank0(_IO_CASES[case](topo, flat, str(tmp), *args))


def _case_roundtrip(topo, flat, tmp):
    u = _io_data(IO_SHAPE)
    pen, x = _io_array(topo, IO_WRITER, u)
    path = f"{tmp}/data.bin"
    with _io_open(path, topo, write=True, create=True) as f:
        f.write("u", x)
        stats = dict(f.stats)
    with _io_open(path, topo, read=True) as f:
        _check_gathered(f.read("u", pen), u)
    return stats


def _case_layout(topo, flat, tmp):
    """Raw bytes at the sidecar's offset are the array in global logical
    order (``test/io.jl:62-103``)."""
    import json

    u = _io_data(IO_SHAPE)
    _, x = _io_array(topo, IO_WRITER, u)
    path = f"{tmp}/data.bin"
    with _io_open(path, topo, write=True, create=True) as f:
        f.write("u", x)
    with open(path + ".json") as jf:
        d = json.load(jf)["datasets"][0]
    raw = np.fromfile(path, dtype=np.float64,
                      offset=d["offset_bytes"]).reshape(d["dims_logical"])
    _same(raw, u)


def _case_append(topo, flat, tmp):
    u, v = _io_data(IO_SHAPE, seed=1), _io_data(IO_SHAPE, seed=2)
    pen, x = _io_array(topo, IO_WRITER, u)
    _, y = _io_array(topo, IO_WRITER, v)
    path = f"{tmp}/data.bin"
    with _io_open(path, topo, write=True, create=True) as f:
        f.write("u", x)
    with _io_open(path, topo, append=True, write=True) as f:
        f.write("v", y)
    with _io_open(path, topo, read=True) as f:
        assert {d["name"] for d in f.datasets} == {"u", "v"}
        _check_gathered(f.read("u", pen), u)
        _check_gathered(f.read("v", pen), v)


def _case_restart(topo, flat, tmp):
    """Write under one decomposition, read under others
    (``mpi_io.jl:159-167``): another decomposition and memory order on
    the same ranks, and a 1-D topology of them."""
    u = _io_data(IO_SHAPE)
    _, x = _io_array(topo, IO_WRITER, u)
    path = f"{tmp}/data.bin"
    with _io_open(path, topo, write=True, create=True) as f:
        f.write("u", x)
    pens = [_sub_pencil(topo, IO_SHAPE, *IO_READER),
            _sub_pencil(flat, IO_SHAPE, (1,), None)]
    with _io_open(path, topo, read=True) as f:
        for p in pens:
            y = f.read("u", p)
            assert y.pencil == p
            _check_gathered(y, u)


def _case_chunks(topo, flat, tmp):
    import json

    from pencilarrays_tpu_torch.parallel.pencil import MemoryOrder

    u = _io_data(IO_SHAPE)
    _, x = _io_array(topo, IO_WRITER, u)
    path = f"{tmp}/chunked.bin"
    with _io_open(path, topo, write=True, create=True) as f:
        f.write("u", x, chunks=True)
    with open(path + ".json") as jf:
        d = json.load(jf)["datasets"][0]
    assert d["layout"] == "chunks" and len(d["chunk_map"]) == len(topo)
    # this rank's chunk bytes are its block in memory order
    # (mpi_io.jl:382-424)
    ch = d["chunk_map"][topo.rank_local]
    raw = np.fromfile(path, dtype=np.float64,
                      count=int(np.prod(ch["dims_memory"])),
                      offset=ch["offset_bytes"]).reshape(ch["dims_memory"])
    true = x.pencil.size_local(None, MemoryOrder)
    _same(raw, x.data[tuple(slice(0, n) for n in true)].numpy())
    pen2 = _sub_pencil(topo, IO_SHAPE, (0, 2), None)
    with _io_open(path, topo, read=True) as f:
        _check_gathered(f.read("u", pen2), u)
        _check_gathered(f.read("u", _sub_pencil(topo, IO_SHAPE,
                                                *IO_READER)), u)


def _case_extra_dims(topo, flat, tmp):
    u = _io_data((6, 8, 9), extra=(3,))
    pen, x = _io_array(topo, ((1, 2), None), u, shape=(6, 8, 9))
    path = f"{tmp}/vec.bin"
    with _io_open(path, topo, write=True, create=True) as f:
        f.write("v", x)
    with _io_open(path, topo, read=True) as f:
        y = f.read("v", pen)
    assert y.extra_dims == (3,)
    _check_gathered(y, u)


def _case_append_creates(topo, flat, tmp):
    """append on a missing file creates it (Julia open-flags semantics)."""
    u = _io_data(IO_SHAPE)
    pen, x = _io_array(topo, IO_WRITER, u)
    path = f"{tmp}/fresh.bin"
    with _io_open(path, topo, append=True) as f:
        f.write("u", x)
    with _io_open(path, topo, read=True) as f:
        _check_gathered(f.read("u", pen), u)


def _case_raw_read(topo, flat, tmp):
    import os

    u = _io_data(IO_SHAPE)
    pen, x = _io_array(topo, IO_WRITER, u)
    path = f"{tmp}/data.bin"
    with _io_open(path, topo, write=True, create=True) as f:
        f.write("u", x)
    _barrier(topo, "raw_written")
    if topo.rank_local == 0:
        os.remove(path + ".json")
    _barrier(topo, "raw_removed")
    with _io_open(path, topo, read=True) as f:
        _check_gathered(f.read_raw(pen, np.float64, offset=0), u)


def _case_validation(topo, flat, tmp):
    import pytest

    u = _io_data(IO_SHAPE)
    _, x = _io_array(topo, IO_WRITER, u)
    path = f"{tmp}/data.bin"
    with _io_open(path, topo, write=True, create=True) as f:
        f.write("u", x)
    with _io_open(path, topo, read=True) as f:
        with pytest.raises(KeyError):
            f.read("nope", x.pencil)
        with pytest.raises(ValueError, match="dims"):
            f.read("u", _sub_pencil(topo, (11, 13, 11), (1, 2), None))
    with pytest.raises(PermissionError):
        with _io_open(path, topo, read=True) as f:
            f.write("w", x)


def _case_uniquify(topo, flat, tmp):
    from pencilarrays_tpu_torch.io import BinaryDriver

    u, v = _io_data(IO_SHAPE, seed=1), _io_data(IO_SHAPE, seed=2)
    pen, x = _io_array(topo, IO_WRITER, u)
    _, y = _io_array(topo, IO_WRITER, v)
    path = f"{tmp}/uq.bin"
    with _io_open(path, topo, BinaryDriver(uniquify_names=True), write=True,
                  create=True) as f:
        f.write("u", x)
        f.write("u", y)
    with _io_open(path, topo, read=True) as f:
        assert {d["name"] for d in f.datasets} == {"u", "u(2)"}
        _check_gathered(f.read("u", pen), u)
        _check_gathered(f.read("u(2)", pen), v)


def _case_rewrite_reuses_offset(topo, flat, tmp):
    """A same-size rewrite ping-pongs between two regions: bounded file
    growth, and the sidecar's current region is never overwritten."""
    import os

    us = [_io_data(IO_SHAPE, seed=s) for s in (1, 2, 3)]
    pen, x = _io_array(topo, IO_WRITER, us[0])
    _, y = _io_array(topo, IO_WRITER, us[1])
    _, z = _io_array(topo, IO_WRITER, us[2])
    path = f"{tmp}/rw.bin"
    with _io_open(path, topo, write=True, create=True) as f:
        f.write("u", x)
        f.write("v", y)
    with _io_open(path, topo, append=True, write=True) as f:
        f.write("u", y)  # first rewrite allocates the spare region
    size1 = os.path.getsize(path)
    for arr in (z, x, y, z):
        with _io_open(path, topo, append=True, write=True) as f:
            f.write("u", arr)
    assert os.path.getsize(path) == size1
    with _io_open(path, topo, read=True) as f:
        _check_gathered(f.read("u", pen), us[2])
        _check_gathered(f.read("v", pen), us[1])


def _case_rewrite_crash(topo, flat, tmp):
    """Bytes the pre-rewrite sidecar references survive the rewrite, so a
    crash before the sidecar flush (the old sidecar put back) still reads
    the previous data."""
    import shutil

    u, w = _io_data(IO_SHAPE, seed=6), _io_data(IO_SHAPE, seed=7)
    pen, x = _io_array(topo, IO_WRITER, u)
    _, z = _io_array(topo, IO_WRITER, w)
    path = f"{tmp}/crash.bin"
    with _io_open(path, topo, write=True, create=True) as f:
        f.write("u", x)
    if topo.rank_local == 0:
        shutil.copy(path + ".json", path + ".json.bak")
    _barrier(topo, "crash_saved")
    with _io_open(path, topo, append=True, write=True) as f:
        f.write("u", z)
    if topo.rank_local == 0:
        shutil.copy(path + ".json.bak", path + ".json")
    _barrier(topo, "crash_rolled_back")
    with _io_open(path, topo, read=True) as f:
        _check_gathered(f.read("u", pen), u)


def _case_reuse_regions_off(topo, flat, tmp):
    import os

    from pencilarrays_tpu_torch.io import BinaryDriver

    u, w = _io_data(IO_SHAPE, seed=4), _io_data(IO_SHAPE, seed=5)
    pen, x = _io_array(topo, IO_WRITER, u)
    _, z = _io_array(topo, IO_WRITER, w)
    path = f"{tmp}/ao.bin"
    drv = BinaryDriver(reuse_regions=False)
    with _io_open(path, topo, drv, write=True, create=True) as f:
        f.write("u", x)
    size0 = os.path.getsize(path)
    with _io_open(path, topo, drv, append=True, write=True) as f:
        f.write("u", z)
    assert os.path.getsize(path) == 2 * size0  # appended, not reused
    with _io_open(path, topo, read=True) as f:
        _check_gathered(f.read("u", pen), w)


def _case_collection(topo, flat, tmp):
    """A (u, v, w, p) state writes as ONE dataset and restarts under a
    different decomposition in one call."""
    us = [_io_data(IO_SHAPE, seed=20 + i) for i in range(4)]
    xs = [_io_array(topo, IO_WRITER, u)[1] for u in us]
    path = f"{tmp}/coll.bin"
    with _io_open(path, topo, write=True, create=True) as f:
        f.write("state", tuple(xs))
    pen2 = _sub_pencil(topo, IO_SHAPE, (0, 1), None)
    with _io_open(path, topo, read=True) as f:
        back = f.read("state", pen2)
    assert isinstance(back, tuple) and len(back) == 4
    for u, b in zip(us, back):
        assert b.extra_dims == ()
        _check_gathered(b, u)


def _case_collection_chunks_extra(topo, flat, tmp):
    us = [_io_data(IO_SHAPE, extra=(2,), seed=30 + i) for i in range(3)]
    xs = [_io_array(topo, IO_WRITER, u)[1] for u in us]
    path = f"{tmp}/collc.bin"
    with _io_open(path, topo, write=True, create=True) as f:
        f.write("state", list(xs), chunks=True)
    with _io_open(path, topo, read=True) as f:
        back = f.read("state", xs[0].pencil)
    assert isinstance(back, tuple) and len(back) == 3
    for u, b in zip(us, back):
        assert b.extra_dims == (2,)
        _check_gathered(b, u)


def _case_collection_streams_host(topo, flat, tmp):
    """A collection write stages each component into the host block: the
    blocks are host NumPy arrays with the component dim trailing."""
    from pencilarrays_tpu_torch.io.binary import iter_local_blocks
    from pencilarrays_tpu_torch.io.core import CollectionView, \
        pack_collection

    xs = [_io_array(topo, IO_WRITER, _io_data(IO_SHAPE, seed=60 + i))[1]
          for i in range(3)]
    view, n = pack_collection(tuple(xs))
    assert isinstance(view, CollectionView) and n == 3
    assert view.extra_dims == (3,)
    whole = [x.logical().numpy() for x in xs]   # collectives: every rank
    blocks = list(iter_local_blocks(view))
    for start, b in blocks:
        assert isinstance(b, np.ndarray) and b.shape[-1] == 3
        assert start[-1] == 0
        at = tuple(slice(s, s + m) for s, m in zip(start, b.shape[:-1]))
        for i, w in enumerate(whole):
            _same(b[..., i], w[at])
    return len(blocks)


def _case_without_native(topo, flat, tmp):
    """The NumPy memmap path writes and reads the same bytes."""
    from pencilarrays_tpu_torch.io import native

    u = _io_data(IO_SHAPE)
    pen, x = _io_array(topo, IO_WRITER, u)
    path = f"{tmp}/fallback.bin"
    saved = native.available
    native.available = lambda: False
    try:
        with _io_open(path, topo, write=True, create=True) as f:
            f.write("u", x)
            assert f.stats["path"] == "memmap"
        with _io_open(path, topo, read=True) as f:
            y = f.read("u", _sub_pencil(topo, IO_SHAPE, *IO_READER))
    finally:
        native.available = saved
    _check_gathered(y, u)
    with _io_open(path, topo, read=True) as f:
        _check_gathered(f.read("u", pen), u)


def _h5_open(path, topo, **mode):
    from pencilarrays_tpu_torch.io import HDF5Driver, open_file

    chunks = mode.pop("chunks", False)
    return open_file(HDF5Driver(chunks=chunks), path, comm=topo.group,
                     **mode)


def _case_h5_roundtrip_attrs(topo, flat, tmp):
    """HDF5 round trip, attribute metadata, plain-h5py readability,
    decomposition-independent restore (``test/io.jl:135-189``) and
    in-place rewrites."""
    import os

    import h5py
    import pytest

    u = _io_data(IO_SHAPE, extra=(2,))
    pen, x = _io_array(topo, IO_WRITER, u)
    path = f"{tmp}/data.h5"
    with _h5_open(path, topo, write=True, create=True) as f:
        f.write("u", x)
    with h5py.File(path, "r") as h:
        _same(h["u"][...], u)
    with _h5_open(path, topo, read=True) as f:
        assert f.datasets() == ["u"]
        attrs = f.attributes("u")
        assert attrs["decomposed_dims"] == [1, 2]
        assert attrs["permutation"] == [2, 0, 1]
        assert attrs["process_dims"] == list(topo.dims)
        _check_gathered(f.read("u", pen), u)
        _check_gathered(f.read("u", _sub_pencil(flat, IO_SHAPE, (1,),
                                                None)), u)
        with pytest.raises(ValueError, match="dims"):
            f.read("u", _sub_pencil(topo, (11, 13, 11), (1, 2), None))
    size_before = os.path.getsize(path)
    v = _io_data(IO_SHAPE, extra=(2,), seed=9)
    _, xv = _io_array(topo, IO_WRITER, v)
    with _h5_open(path, topo, append=True) as f:
        f.write("u", xv)
    with _h5_open(path, topo, read=True) as f:
        _check_gathered(f.read("u", pen), v)
    if len(topo) == 1:   # one writer reuses the dataset in place
        assert os.path.getsize(path) < size_before + u.nbytes // 2


def _case_h5_chunked(topo, flat, tmp):
    import h5py

    u = _io_data(IO_SHAPE)
    pen, x = _io_array(topo, IO_WRITER, u)
    path = f"{tmp}/ck.h5"
    with _h5_open(path, topo, chunks=True, write=True, create=True) as f:
        f.write("u", x)
    if len(topo) == 1:
        with h5py.File(path, "r") as h:
            assert h["u"].chunks is not None
    with h5py.File(path, "r") as h:
        _same(h["u"][...], u)
    with _h5_open(path, topo, read=True) as f:
        _check_gathered(f.read("u", pen), u)


def _case_h5_bf16(topo, flat, tmp):
    """bfloat16 stores as its bit pattern with a marker attribute."""
    u = _io_data((8, 8, 8), dtype="float32")
    pen = _sub_pencil(topo, (8, 8, 8), (1, 2), None)
    x = pat.PencilArray.from_global(pen, torch.from_numpy(u).bfloat16())
    path = f"{tmp}/bf16.h5"
    with _h5_open(path, topo, write=True, create=True) as f:
        f.write("u", x)
    with _h5_open(path, topo, read=True) as f:
        y = f.read("u", pen)
    assert y.dtype == torch.bfloat16
    _check_gathered(y, torch.from_numpy(u).bfloat16().float().numpy())


def _case_h5_collection(topo, flat, tmp):
    us = [_io_data(IO_SHAPE, seed=40 + i) for i in range(4)]
    xs = [_io_array(topo, IO_WRITER, u)[1] for u in us]
    path = f"{tmp}/coll.h5"
    with _h5_open(path, topo, write=True, create=True) as f:
        f.write("state", tuple(xs))
    pen2 = _sub_pencil(topo, IO_SHAPE, (0, 2), None)
    with _h5_open(path, topo, read=True) as f:
        back = f.read("state", pen2)
    assert isinstance(back, tuple) and len(back) == 4
    for u, b in zip(us, back):
        _check_gathered(b, u)
    # a single-array rewrite under the same name clears the marker
    with _h5_open(path, topo, append=True, write=True) as f:
        f.write("state", xs[0])
    with _h5_open(path, topo, read=True) as f:
        one = f.read("state", xs[0].pencil)
    assert not isinstance(one, tuple)


def _case_orbax(topo, flat, tmp):
    """The Orbax driver on several ranks: an f64 field, an f32 field with
    an extra dim and a collection written from one pencil (gathered to the
    topology's rank 0), read back on every rank under another
    decomposition and memory order, bit for bit, synchronous and async."""
    from pencilarrays_tpu_torch.io import OrbaxDriver

    u = _io_data(IO_SHAPE, seed=31)
    v = _io_data(IO_SHAPE, (2,), seed=32, dtype="float32")
    w = (_io_data(IO_SHAPE, seed=33), _io_data(IO_SHAPE, seed=34))
    _, x = _io_array(topo, IO_WRITER, u)
    _, y = _io_array(topo, IO_WRITER, v)
    comps = tuple(_io_array(topo, IO_WRITER, c)[1] for c in w)
    reader = _sub_pencil(topo, IO_SHAPE, *IO_READER)
    for async_write in (False, True):
        path = f"{tmp}/orbax{int(async_write)}"
        with _io_open(path, topo, OrbaxDriver(async_write=async_write),
                      write=True, create=True) as f:
            f.write("u", x)
            f.write("v", y)
            f.write("w", comps)
        with _io_open(path, topo, OrbaxDriver(), read=True) as f:
            assert f.datasets() == ["u", "v", "w"]
            _check_gathered(f.read("u", reader), u)
            _check_gathered(f.read("v", reader), v)
            for got, want in zip(f.read("w", reader), w):
                _check_gathered(got, want)


_IO_CASES = {
    "roundtrip": _case_roundtrip,
    "layout": _case_layout,
    "append": _case_append,
    "restart": _case_restart,
    "chunks": _case_chunks,
    "extra_dims": _case_extra_dims,
    "append_creates": _case_append_creates,
    "raw_read": _case_raw_read,
    "validation": _case_validation,
    "uniquify": _case_uniquify,
    "rewrite_reuses_offset": _case_rewrite_reuses_offset,
    "rewrite_crash": _case_rewrite_crash,
    "reuse_regions_off": _case_reuse_regions_off,
    "collection": _case_collection,
    "collection_chunks_extra": _case_collection_chunks_extra,
    "collection_streams_host": _case_collection_streams_host,
    "without_native": _case_without_native,
    "h5_roundtrip_attrs": _case_h5_roundtrip_attrs,
    "h5_chunked": _case_h5_chunked,
    "h5_bf16": _case_h5_bf16,
    "h5_collection": _case_h5_collection,
    "orbax": _case_orbax,
}


def _bits_to_torch(a, bf16):
    t = torch.from_numpy(np.array(a, copy=True))
    return t.view(torch.bfloat16) if bf16 else t


def io_cross_read(dims, tmp, spec, verify_local=True):
    """Read the JAX package's files under ``tmp`` (``jax.bin``,
    ``jax.h5`` when present, checkpoint ``ckpt``) into a pencil of
    ``spec`` on ``dims``: every dataset gathered (bfloat16 as its bits),
    with the checkpoint verified in full and, if asked, locally."""
    import os

    from pencilarrays_tpu_torch.io import BinaryDriver, HDF5Driver
    from pencilarrays_tpu_torch.resilience import CheckpointManager

    topo = sub_topology(dims)
    if topo is None:
        return None
    pen = _sub_pencil(topo, IO_SHAPE, *spec)
    out = {}

    def put(key, y):
        if isinstance(y, tuple):
            for i, c in enumerate(y):
                put(f"{key}[{i}]", c)
            return
        if y.dtype == torch.bfloat16:
            y = pat.PencilArray(y.pencil, y.data.view(torch.int16),
                                y.extra_dims)
        out[key] = pat.gather(y)

    with _io_open(f"{tmp}/jax.bin", topo, read=True) as f:
        for d in f.datasets:
            put(f"bin:{d['name']}", f.read(d["name"], pen))
    if os.path.exists(f"{tmp}/jax.h5"):
        with _io_open(f"{tmp}/jax.h5", topo, HDF5Driver(), read=True) as f:
            for name in f.datasets():
                put(f"h5:{name}", f.read(name, pen))
    mgr = CheckpointManager(f"{tmp}/ckpt", comm=topo.group)
    assert mgr.latest_valid() == mgr.steps()[-1]
    for step in mgr.steps():
        mgr.verify(step)
        ck = mgr.restore(step)
        for name in ck.datasets:
            put(f"ckpt{step}:{name}", ck.read(name, pen, verify=True))
            if verify_local:
                put(f"ckpt{step}local:{name}",
                    ck.read(name, pen, verify="local"))
    return _rank0(out)


def io_cross_write(dims, tmp, spec, data, bf16=(), h5=True):
    """Write ``data`` ({name: global array, or tuple of arrays for a
    collection}; names in ``bf16`` hold bfloat16 bits) from a pencil of
    ``spec`` on ``dims`` into ``tmp``: ``port.bin`` (``c*`` names in the
    chunks layout), ``port.h5`` and a checkpoint ``ckpt`` of step 1."""
    from pencilarrays_tpu_torch.io import HDF5Driver
    from pencilarrays_tpu_torch.resilience import CheckpointManager

    topo = sub_topology(dims)
    if topo is None:
        return None
    pen = _sub_pencil(topo, IO_SHAPE, *spec)

    def arr(u, name):
        t = _bits_to_torch(u, name in bf16)
        return pat.PencilArray.from_global(pen, t, t.dim() - 3)

    xs = {n: tuple(arr(c, n) for c in u) if isinstance(u, tuple)
          else arr(u, n) for n, u in data.items()}
    with _io_open(f"{tmp}/port.bin", topo, write=True, create=True) as f:
        for n, x in xs.items():
            f.write(n, x, chunks=n.startswith("c"))
    if h5:
        with _io_open(f"{tmp}/port.h5", topo, HDF5Driver(), write=True,
                      create=True) as f:
            for n, x in xs.items():
                if not n.startswith("c"):
                    f.write(n, x)
    mgr = CheckpointManager(f"{tmp}/ckpt", comm=topo.group)
    mgr.save(1, {n: x for n, x in xs.items() if not n.startswith("c")})
    return _rank0(True)


def ckpt_case(dims, case, tmp, *args):
    """Run the checkpoint case ``case`` of ``_CKPT_CASES`` on a CPU
    topology of ``dims`` over the pool's first ranks (as ``io_case``)."""
    import math

    topo = sub_topology(dims)
    flat = sub_topology((math.prod(dims),))
    if topo is None:
        return None
    return _rank0(_CKPT_CASES[case](topo, flat, str(tmp), *args))


def _mgr(topo, directory, **kw):
    from pencilarrays_tpu_torch.resilience import CheckpointManager

    return CheckpointManager(directory, comm=topo.group, **kw)


def _on_rank0(topo, name, fn):
    """``fn()`` on rank 0 of ``topo``, then a barrier."""
    if topo.rank_local == 0:
        fn()
    _barrier(topo, name)


def _flip(path, offset, mask=0x01):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ mask]))


def _ck_roundtrip_layout(topo, flat, tmp):
    import json
    import os

    u, v = _io_data(IO_SHAPE, seed=1), _io_data(IO_SHAPE, (2,), seed=2)
    _, x = _io_array(topo, IO_WRITER, u)
    _, y = _io_array(topo, IO_WRITER, v)
    mgr = _mgr(topo, tmp, keep=4)
    p = mgr.save(7, {"u": x, "v": y})
    assert sorted(os.listdir(p)) == ["COMMIT", "MANIFEST.json", "data.bin",
                                     "data.bin.json"]
    with open(os.path.join(p, "MANIFEST.json")) as f:
        mf = json.load(f)
    assert mf["step"] == 7 and mf["driver"] == "BinaryDriver"
    assert set(mf["datasets"]) == {"u", "v"}
    blocks = mf["datasets"]["u"]["blocks"]
    assert len(blocks) == len(topo)
    assert all({"start", "shape", "crc"} <= set(b) for b in blocks)
    assert sum(int(np.prod(b["shape"])) for b in blocks) == u.size
    mgr.verify(7)
    assert mgr.latest_valid() == 7
    ck = mgr.restore()
    assert ck.datasets == ["u", "v"]
    _check_gathered(ck.read("u", _sub_pencil(topo, IO_SHAPE, (0, 1),
                                             None)), u)
    _check_gathered(ck.read("v", _sub_pencil(flat, IO_SHAPE, (1,), None)),
                    v)
    return mgr.stats


def _ck_collections(topo, flat, tmp):
    us = [_io_data(IO_SHAPE, seed=20 + i) for i in range(3)]
    xs = [_io_array(topo, IO_WRITER, u)[1] for u in us]
    mgr = _mgr(topo, tmp)
    mgr.save(1, {"state": tuple(xs)})
    back = mgr.restore().read("state", _sub_pencil(topo, IO_SHAPE, (0, 2),
                                                    None))
    assert isinstance(back, tuple) and len(back) == 3
    for u, b in zip(us, back):
        _check_gathered(b, u)


def _ck_retention_gc(topo, flat, tmp):
    import os

    _, x = _io_array(topo, IO_WRITER, _io_data(IO_SHAPE))
    mgr = _mgr(topo, tmp, keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, {"u": x})
    assert mgr.steps() == [3, 4]
    assert sorted(os.listdir(tmp)) == ["step-00000003", "step-00000004"]


def _ck_uncommitted_skipped(topo, flat, tmp):
    import os

    import pytest
    from pencilarrays_tpu_torch.resilience import CheckpointNotFoundError

    u, w = _io_data(IO_SHAPE, seed=3), _io_data(IO_SHAPE, seed=4)
    pen, x = _io_array(topo, IO_WRITER, u)
    _, z = _io_array(topo, IO_WRITER, w)
    mgr = _mgr(topo, tmp)
    mgr.save(1, {"u": x})
    p2 = mgr.save(2, {"u": z})
    _on_rank0(topo, "uncommit", lambda: os.unlink(os.path.join(p2,
                                                               "COMMIT")))
    assert mgr.latest_valid() == 1
    _check_gathered(mgr.restore().read("u", pen), u)
    with pytest.raises(CheckpointNotFoundError):
        mgr.restore(2)
    mgr.save(3, {"u": x})     # the next save's GC sweeps the torn step
    assert not os.path.exists(p2)


def _ck_resave(topo, flat, tmp):
    import os

    u, v = _io_data(IO_SHAPE, seed=16), _io_data(IO_SHAPE, seed=17)
    pen, x = _io_array(topo, IO_WRITER, u)
    _, y = _io_array(topo, IO_WRITER, v)
    mgr = _mgr(topo, tmp)
    mgr.save(1, {"u": x})
    mgr.save(1, {"u": y})
    assert mgr.steps() == [1]
    assert sorted(os.listdir(tmp)) == ["step-00000001"]
    _check_gathered(mgr.restore(1).read("u", pen), v)


def _ck_unknown_algo(topo, flat, tmp):
    """A checksum algorithm this host cannot compute degrades verification
    to structural checks, never a false failure."""
    import json
    import os

    u = _io_data(IO_SHAPE, seed=18)
    pen, x = _io_array(topo, IO_WRITER, u)
    mgr = _mgr(topo, tmp)
    p = mgr.save(1, {"u": x})
    mpath = os.path.join(p, "MANIFEST.json")

    def forge():
        with open(mpath) as f:
            mf = json.load(f)
        mf["algo"] = "crc64-nvme"
        with open(mpath, "w") as f:
            json.dump(mf, f)
    _on_rank0(topo, "forge", forge)
    mgr.verify(1)
    assert mgr.latest_valid() == 1
    _check_gathered(mgr.restore().read("u", pen), u)


def _ck_crash_before_commit(topo, flat, tmp):
    import os

    import pytest
    from pencilarrays_tpu_torch.resilience import InjectedFault, faults

    u, w = _io_data(IO_SHAPE, seed=5), _io_data(IO_SHAPE, seed=6)
    pen, x = _io_array(topo, IO_WRITER, u)
    _, z = _io_array(topo, IO_WRITER, w)
    mgr = _mgr(topo, tmp)
    mgr.save(1, {"u": x})
    with faults.active("ckpt.commit:error"):
        with pytest.raises(InjectedFault):
            mgr.save(2, {"u": z})
    _barrier(topo, "after_crash")
    assert mgr.latest_valid() == 1
    assert not os.path.exists(mgr._step_dir(2))
    _check_gathered(mgr.restore().read("u", pen), u)


def _ck_transient_retried(topo, flat, tmp):
    """Transient errors at the sidecar flush (rank 0's commit point) and
    at the restore's open are absorbed by the retry policy."""
    from pencilarrays_tpu_torch.resilience import RetryPolicy, faults

    u = _io_data(IO_SHAPE, seed=7)
    pen, x = _io_array(topo, IO_WRITER, u)
    fast = RetryPolicy(max_attempts=5, base_delay=0.001, deadline=5.0)
    mgr = _mgr(topo, tmp, retry=fast)
    with faults.active("io.flush_meta:error*2"):
        mgr.save(1, {"u": x})
    assert mgr.latest_valid() == 1
    with faults.active("io.open:error*1"):
        _check_gathered(mgr.restore().read("u", pen), u)


def _ck_corruption_named(topo, flat, tmp):
    import json
    import os

    import pytest
    from pencilarrays_tpu_torch.resilience import (CheckpointNotFoundError,
                                                   CorruptCheckpointError)

    u, v = _io_data(IO_SHAPE, seed=8), _io_data(IO_SHAPE, seed=9)
    pen, x = _io_array(topo, IO_WRITER, u)
    _, y = _io_array(topo, IO_WRITER, v)
    mgr = _mgr(topo, tmp)
    p = mgr.save(1, {"u": x, "v": y})
    with open(os.path.join(p, "data.bin.json")) as f:
        d = next(d for d in json.load(f)["datasets"] if d["name"] == "v")
    _on_rank0(topo, "flip", lambda: _flip(os.path.join(p, "data.bin"),
                                          d["offset_bytes"] + 128))
    with pytest.raises(CorruptCheckpointError, match=r"'v' block \d+") as ei:
        mgr.verify(1)
    e = ei.value
    assert e.dataset == "v" and e.block is not None and e.step == 1
    with pytest.raises(CorruptCheckpointError):
        mgr.restore(1).read("v", pen)
    _check_gathered(mgr.restore(1).read("u", pen), u)
    assert mgr.latest_valid() is None
    with pytest.raises(CheckpointNotFoundError):
        mgr.restore()


def _ck_hdf5(topo, flat, tmp):
    import os

    import h5py
    import pytest
    from pencilarrays_tpu_torch.io import HDF5Driver
    from pencilarrays_tpu_torch.resilience import ResilienceError

    u = _io_data(IO_SHAPE, seed=10)
    _, x = _io_array(topo, IO_WRITER, u)
    mgr = _mgr(topo, tmp, driver=HDF5Driver())
    p = mgr.save(1, {"u": x})
    assert os.path.exists(os.path.join(p, "data.h5"))
    mgr.verify(1)
    _check_gathered(mgr.restore().read("u", _sub_pencil(topo, IO_SHAPE,
                                                        (0, 1), None)), u)
    # flip one byte inside the stored data: the dataset itself with one
    # writer, rank 0's shard file behind the virtual dataset with several
    path, dset = ((os.path.join(p, "data.h5"), "u") if len(topo) == 1
                  else (os.path.join(p, "data.h5.r0"), "u/r0"))
    with h5py.File(path, "r") as h:
        off = h[dset].id.get_offset()
    assert off is not None
    _on_rank0(topo, "flip", lambda: _flip(path, off + 40, 0xFF))
    with pytest.raises(ResilienceError):
        mgr.verify(1)


def _ck_checksums_off(topo, flat, tmp):
    import json
    import os

    u = _io_data(IO_SHAPE, seed=11)
    pen, x = _io_array(topo, IO_WRITER, u)
    mgr = _mgr(topo, tmp, checksums=False)
    p = mgr.save(1, {"u": x})
    with open(os.path.join(p, "MANIFEST.json")) as f:
        mf = json.load(f)
    assert mf["algo"] is None and mf["datasets"]["u"]["blocks"] is None
    assert mgr.latest_valid() == 1
    _check_gathered(mgr.restore().read("u", pen), u)

    def wreck():
        with open(os.path.join(p, "data.bin.json"), "w") as f:
            f.write("{not json")
    _on_rank0(topo, "wreck", wreck)
    assert mgr.latest_valid() is None


def _ck_checksums_off_chunks(topo, flat, tmp):
    """Checksums-off verification is structural only, and accepts the
    chunks layout the block reader cannot describe."""
    u = _io_data(IO_SHAPE, seed=21)
    pen, x = _io_array(topo, IO_WRITER, u)
    mgr = _mgr(topo, tmp, checksums=False)
    mgr.save(0, {"u": x}, chunks=True)
    assert mgr.latest_valid() == 0
    _check_gathered(mgr.restore().read("u", pen), u)


def _ck_interrupted_resave(topo, flat, tmp):
    """A crash between moving the old committed step aside and committing
    its replacement: latest_valid() recovers the moved-aside copy."""
    import os

    u, w = _io_data(IO_SHAPE, seed=22), _io_data(IO_SHAPE, seed=23)
    pen, x = _io_array(topo, IO_WRITER, u)
    _, y = _io_array(topo, IO_WRITER, w)
    mgr = _mgr(topo, tmp, keep=1)
    p = mgr.save(5, {"u": x})

    def crash():
        os.rename(p, os.path.join(tmp, ".tmp-step-00000005-replaced"))
        os.makedirs(p)
        with open(os.path.join(p, "data.bin"), "wb") as f:
            f.write(b"torn")
    _on_rank0(topo, "crash", crash)
    if topo.rank_local == 0:
        assert mgr.latest_valid() == 5      # recovered, not lost
    _barrier(topo, "recovered")
    assert mgr.latest_valid() == 5
    _check_gathered(mgr.restore(5).read("u", pen), u)
    mgr.save(6, {"u": y})
    assert mgr.steps() == [6]


def _ck_bad_configs(topo, flat, tmp):
    import pytest
    from pencilarrays_tpu_torch.io import HDF5Driver, OrbaxDriver
    from pencilarrays_tpu_torch.resilience import CheckpointNotFoundError

    _, x = _io_array(topo, IO_WRITER, _io_data(IO_SHAPE))
    with pytest.raises(ValueError, match="checksums"):
        _mgr(topo, tmp, driver=OrbaxDriver())
    mgr = _mgr(topo, tmp)
    with pytest.raises(ValueError, match="chunks"):
        mgr.save(1, {"u": x}, chunks=True)
    mgr_h = _mgr(topo, tmp, driver=HDF5Driver(), checksums=False)
    with pytest.raises(ValueError, match="BinaryDriver layout"):
        mgr_h.save(1, {"u": x}, chunks=True)
    with pytest.raises(ValueError, match="empty"):
        mgr.save(1, {})
    with pytest.raises(CheckpointNotFoundError):
        mgr.restore()
    # a host-pool save on several ranks needs a side group for its barriers
    if len(topo) > 1:
        with pytest.raises(ValueError, match="side_group"):
            mgr.save_async(1, {"u": x})


def _ck_truncation_fuzz(topo, flat, tmp):
    """Truncate or corrupt checkpoint files at seeded offsets: every
    outcome is a bit-identical restore of INTACT data or a typed
    ResilienceError, never silently wrong data."""
    import os
    import shutil

    from pencilarrays_tpu_torch.resilience import ResilienceError

    u = _io_data(IO_SHAPE, seed=12)
    pen, x = _io_array(topo, IO_WRITER, u)
    pristine = os.path.join(tmp, "pristine")
    _mgr(topo, pristine, keep=1).save(1, {"u": x})
    rng = np.random.default_rng(2026)
    targets = ["data.bin", "data.bin.json", "MANIFEST.json", "COMMIT"]
    outcomes = {"restored": 0, "typed_error": 0}
    for trial in range(24):
        work = os.path.join(tmp, f"fuzz{trial}")
        victim = os.path.join(work, "step-00000001",
                              targets[trial % len(targets)])
        mode = ["truncate", "flip", "zero"][trial % 3]
        draws = rng.integers(0, 1 << 62, size=2)

        def damage():
            shutil.copytree(os.path.join(pristine, "step-00000001"),
                            os.path.join(work, "step-00000001"))
            size = os.path.getsize(victim)
            with open(victim, "r+b") as f:
                if mode == "truncate" or size == 0:
                    f.truncate(int(draws[0] % max(size, 1)))
                else:
                    off = int(draws[1] % size)
                    f.seek(off)
                    b = f.read(1) or b"\0"
                    f.seek(off)
                    f.write(bytes([b[0] ^ (0xFF if mode == "flip"
                                           else b[0])]))
        _on_rank0(topo, f"fuzz{trial}", damage)
        mgr = _mgr(topo, work, keep=1)
        step = mgr.latest_valid()
        if step is None:
            outcomes["typed_error"] += 1
            continue
        try:
            back = mgr.restore(step).read("u", pen)
        except ResilienceError:
            outcomes["typed_error"] += 1
            continue
        _check_gathered(back, u)
        outcomes["restored"] += 1
    assert outcomes["typed_error"] > 0 and outcomes["restored"] > 0
    return outcomes


def _ck_older_fallback(topo, flat, tmp):
    import os

    u1, u2 = _io_data(IO_SHAPE, seed=13), _io_data(IO_SHAPE, seed=14)
    pen, x1 = _io_array(topo, IO_WRITER, u1)
    _, x2 = _io_array(topo, IO_WRITER, u2)
    mgr = _mgr(topo, tmp, keep=5)
    mgr.save(1, {"u": x1})
    p2 = mgr.save(2, {"u": x2})

    def cut():
        path = os.path.join(p2, "data.bin")
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
    _on_rank0(topo, "cut", cut)
    assert mgr.latest_valid() == 1 and mgr.valid_steps() == [1]
    assert mgr.common_latest_valid() == 1
    _check_gathered(mgr.restore().read("u", pen), u1)


def _ck_observer_blocks(topo, flat, tmp):
    """The manifest CRCs come from the write path's own host blocks: the
    observer sees this rank's logical-order block, whose CRC matches an
    independent computation on the global array."""
    from pencilarrays_tpu_torch.io.binary import iter_local_blocks
    from pencilarrays_tpu_torch.resilience.checksum import (BlockChecksums,
                                                            crc_of_array)

    u = _io_data(IO_SHAPE, seed=15)
    _, x = _io_array(topo, IO_WRITER, u)
    crcs = BlockChecksums()
    observe = crcs.observer("u")
    for start, block in iter_local_blocks(x):
        observe(start, block)
    for b in crcs.blocks("u"):
        sl = tuple(slice(s, s + e) for s, e in zip(b["start"], b["shape"]))
        assert crc_of_array(u[sl]) == b["crc"]
    return len(crcs.blocks("u"))


_CKPT_CASES = {
    "roundtrip_layout": _ck_roundtrip_layout,
    "collections": _ck_collections,
    "retention_gc": _ck_retention_gc,
    "uncommitted_skipped": _ck_uncommitted_skipped,
    "resave": _ck_resave,
    "unknown_algo": _ck_unknown_algo,
    "crash_before_commit": _ck_crash_before_commit,
    "transient_retried": _ck_transient_retried,
    "corruption_named": _ck_corruption_named,
    "hdf5": _ck_hdf5,
    "checksums_off": _ck_checksums_off,
    "checksums_off_chunks": _ck_checksums_off_chunks,
    "interrupted_resave": _ck_interrupted_resave,
    "bad_configs": _ck_bad_configs,
    "truncation_fuzz": _ck_truncation_fuzz,
    "older_fallback": _ck_older_fallback,
    "observer_blocks": _ck_observer_blocks,
}


def ckpt_cross_decomposition(tmp, torn):
    """A checkpoint written on (2, 2) restores onto (4, 1), (1, 2) and one
    rank bit-identically, verified in full and locally; with ``torn`` the
    newest step's data is corrupted, ``latest_valid()`` falls back to
    step 1, and reading the torn step raises a typed failure."""
    import os

    import pytest
    from pencilarrays_tpu_torch.resilience import CorruptCheckpointError

    truth = _io_data(IO_SHAPE, seed=21 + torn)
    writer = sub_topology((2, 2))
    readers = [(sub_topology((4, 1)), ((1, 2), None)),
               (sub_topology((1, 2)), ((0, 1), (2, 0, 1))),
               (sub_topology((1,)), ((2,), None))]
    wpen = pat.Pencil(pat.Topology.unconnected((2, 2)), IO_SHAPE, (1, 2))
    torn_blocks = [rr for rr in (wpen.range_local(wpen.topology.coords(r))
                                 for r in range(4))
                   if all(r.start <= i < r.stop
                          for r, i in zip(rr, (0, 0, 8)))]
    if writer is not None:
        mgr = _mgr(writer, tmp, keep=4)
        x = _io_array(writer, ((1, 2), None), truth)[1]
        mgr.save(1, {"u": x})
        if torn:
            mgr.save(2, {"u": x + 5.0})
            _on_rank0(writer, "tear", lambda: _flip(
                os.path.join(tmp, "step-00000002", "data.bin"), 64, 0xFF))
    torch.distributed.barrier()
    for topo, spec in readers:
        if topo is None:
            continue
        mgr = _mgr(topo, tmp, keep=4)
        pen = _sub_pencil(topo, IO_SHAPE, *spec)
        if torn:
            assert mgr.latest_valid() == 1
            _check_gathered(mgr.restore(1).read("u", pen, verify=True),
                            truth)
            # the flipped byte is element (0, 0, 8): a rank refuses the
            # step when its block meets the writer's block holding it (the
            # one manifest block its local verification reads)
            ck = mgr.restore(2, verify=False)
            if any(all(a.start < b.stop and b.start < a.stop
                       for a, b in zip(pen.range_local(), rr))
                   for rr in torn_blocks):
                with pytest.raises(CorruptCheckpointError):
                    ck.read("u", pen, verify="local")
            else:
                ck.read("u", pen, verify="local")
        else:
            ck = mgr.restore(1)
            _check_gathered(ck.read("u", pen, verify=True), truth)
            _check_gathered(ck.read("u", pen, verify="local"), truth)
    return _rank0(True)


# -- engine/: the async, compiled and measured paths --------------------------


def _on_every_rank(topo, value):
    """``value`` of every rank of ``topo`` (rank order)."""
    out = [None] * len(topo)
    torch.distributed.all_gather_object(out, value, group=topo.group)
    return out


def ns_async_case(dims, n, uh0_padded, dt, nu):
    """One ``step_async`` of the JAX package's Taylor–Green state through a
    private engine, and the port's own ``step`` of it: both gathered, and
    whether every rank's blocks are equal bit for bit."""
    from pencilarrays_tpu_torch.engine import Engine

    topo = sub_topology(dims)
    if topo is None:
        return None
    model = NavierStokesSpectral(topo, n, viscosity=nu, dtype=torch.float32)
    uh0 = from_numpy_padded(model.plan.output_pencil, uh0_padded, (3,))
    e = Engine("ns-async")
    try:
        out = model.step_async(uh0, dt, engine=e).result(120)
    finally:
        e.close()
    ref = model.step(uh0, dt)
    same = _on_every_rank(topo, torch.equal(out.data, ref.data))
    return _rank0(dict(out=pat.gather(out), same=same))


def diffusion_async_case(dims, shape, u0, dt, tmp):
    """``DiffusionSpectral.run_async`` over 5 steps, a checkpoint every 2
    (the manager on a side group made up front by every rank of the
    pool): the committed steps, the final and 2-step sync states, the
    restore of step 2, the host tasks the engine ran, the dispatch log's
    certificate, and the refusal of a save_async whose barriers would
    share the topology's group."""
    import math

    from pencilarrays_tpu_torch.analysis import verify_dispatch_log
    from pencilarrays_tpu_torch.engine import Engine
    from pencilarrays_tpu_torch.parallel import distributed
    from pencilarrays_tpu_torch.resilience import CheckpointManager

    side = distributed.side_group(range(math.prod(dims)))
    topo = sub_topology(dims)
    if topo is None:
        return None
    model = DiffusionSpectral(topo, shape, kappa=1.0, dtype=torch.float32)
    uh = model.from_physical(
        pat.PencilArray.from_global(model.plan.input_pencil, u0))
    e = Engine("pipe-test")
    try:
        ck = CheckpointManager(f"{tmp}/ck", comm=side)
        pipe = model.run_async(uh, dt, 5, engine=e, checkpoint=ck,
                               checkpoint_every=2)
        final = pipe.result(120)
        host = e.stats()["host_tasks"]
        cert = verify_dispatch_log(e.dispatch_log())
        refused = None
        if distributed.is_multiprocess(topo.group):
            try:
                CheckpointManager(f"{tmp}/other", comm=topo.group
                                  ).save_async(1, {"uh": uh}, engine=e)
            except ValueError as err:
                refused = str(err)
    finally:
        e.close()
    states = [uh]
    for _ in range(5):
        states.append(model.step(states[-1], dt))
    restored = ck.restore(2).read("uh", model.plan.output_pencil)
    same = _on_every_rank(topo, (torch.equal(final.data, states[5].data),
                                 torch.equal(restored.data,
                                             states[2].data)))
    return _rank0(dict(steps=ck.steps(), saves=len(pipe.saves),
                       host_tasks=host, dispatches=cert["dispatches"],
                       same=same, final=pat.gather(final),
                       two=pat.gather(states[2]), refused=refused))


def fft_async_case(dims, shape, u):
    """``forward_async`` (ready and pack forms, and donating) and
    ``backward_async`` against the synchronous calls, bit for bit on every
    rank, and the dispatch log's certificate (the exchange calls each
    dispatch counted held to the plan's ``collective_costs``)."""
    from pencilarrays_tpu_torch.analysis import verify_dispatch_log
    from pencilarrays_tpu_torch.engine import Engine

    topo = sub_topology(dims)
    if topo is None:
        return None
    plan = pat.PencilFFTPlan(topo, shape, real=True)
    x = pat.PencilArray.from_global(plan.input_pencil, u)
    given = pat.PencilArray.from_global(plan.input_pencil, u)
    e = Engine("fft-async")
    try:
        f = plan.forward_async(x, engine=e).result(60)
        fp = plan.forward_async(pack=lambda: u, engine=e).result(60)
        fd = plan.forward_async(given, engine=e, donate=True).result(60)
        b = plan.backward_async(f, engine=e).result(60)
        cert = verify_dispatch_log(e.dispatch_log())
    finally:
        e.close()
    ref = plan.forward(x)
    back = plan.backward(ref)
    same = _on_every_rank(topo, [torch.equal(f.data, ref.data),
                                 torch.equal(fp.data, ref.data),
                                 torch.equal(fd.data, ref.data),
                                 torch.equal(b.data, back.data)])
    return _rank0(dict(same=same, cert=cert, donated=given.is_deleted(),
                       costs=plan.collective_costs(),
                       spectral=pat.gather(f)))


def measure_case(dims, shape, u):
    """``Auto(mode="measure")`` for the hop ``(1, 2) -> (0, 2)``: the
    report, every rank's winner, the cache hit of a second resolve, and
    the transpose by the measured method (gathered)."""
    from pencilarrays_tpu_torch.parallel import transpositions as tr

    topo = sub_topology(dims)
    if topo is None:
        return None
    pin = _sub_pencil(topo, shape, (1, 2), None)
    pout = pin.replace(decomp_dims=(0, 2))
    auto = pat.Auto(mode="measure")
    m = tr.resolve_method(pin, pout, (), torch.float32, auto)
    hits = tr._measured_choice.cache_info().hits
    again = tr.resolve_method(pin, pout, (), torch.float32, auto)
    hit = tr._measured_choice.cache_info().hits == hits + 1
    report = tr.last_measure_reports()[-1]
    y = pat.transpose(pat.PencilArray.from_global(pin, u), pout,
                      method=auto)
    winners = _on_every_rank(topo, tr._method_label(m))
    return _rank0(dict(report=report, winners=winners, hit=hit,
                       again=again == m, glob=pat.gather(y)))


def two_thread_case(dims, shape, u, hops, tmp):
    """The engine's consumer runs ``hops`` round trips of an exchange
    (collectives on the topology's groups) while its host pool saves the
    field every other hop (barriers on a side group): both finish, the
    round trips are bit-identical and every save committed."""
    import torch.distributed as dist

    from pencilarrays_tpu_torch.engine import Engine
    from pencilarrays_tpu_torch.parallel import distributed
    from pencilarrays_tpu_torch.resilience import CheckpointManager

    side = distributed.side_group()
    topo = pat.Topology(dims, device="cpu")
    pin = pat.Pencil(topo, shape, (1, 2))
    pout = pin.replace(decomp_dims=(0, 2))
    x = pat.PencilArray.from_global(pin, u)
    ck = CheckpointManager(f"{tmp}/ck", comm=side, keep=None)
    e = Engine("two-threads", workers=2)
    rounds, saves = [], []
    try:
        for k in range(hops):
            rounds.append(e.submit(lambda: pat.transpose(
                pat.transpose(x, pout), pin), label=f"hop:{k}"))
            if k % 2 == 0:
                prev = saves[-1] if saves else None

                def save(k=k, prev=prev):
                    if prev is not None:
                        prev.result()
                    return ck.save(k, {"u": x})

                saves.append(e.host_task(save, label=f"save:{k}"))
        ok = all(torch.equal(f.result(60).data, x.data) for f in rounds)
        for s in saves:
            s.result(60)
    finally:
        e.close()
    dist.barrier()
    return _rank0(dict(ok=_on_every_rank(topo, ok), steps=ck.steps()))


# -- the runtime guard and the mesh observability plane ---------------------


def guard_hop_case(dims, shape, src, dest, u, methods, tmp):
    """Per method on the first ``prod(dims)`` ranks: the unguarded hop,
    the guarded hop, the guarded ``hop.exchange:corrupt`` drill (the
    typed error's kind, raised on every rank alike: the probes are
    summed over the ranks) and the unguarded drill (the poke flows
    through); each hop's padded global bits, rank 0's hop calls counted
    guard off and on, and every rank's verdict."""
    from pencilarrays_tpu_torch import guard
    from pencilarrays_tpu_torch.guard import IntegrityError
    from pencilarrays_tpu_torch.parallel import transpositions as tr
    from pencilarrays_tpu_torch.resilience import faults

    topo = sub_topology(dims)
    if topo is None:
        return None
    pin = _sub_pencil(topo, shape, *src)
    pout = _sub_pencil(topo, shape, *dest)
    x = pat.PencilArray.from_global(pin, u)
    calls = []
    orig = tr._hop

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    out = []
    tr._hop = counted
    try:
        for m in methods:
            guard._reset_for_tests()
            faults.clear()
            del calls[:]
            plain = to_numpy_padded(pat.transpose(x, pout, method=m))
            n_plain = len(calls)
            guard.enable(tmp)
            del calls[:]
            guarded = to_numpy_padded(pat.transpose(x, pout, method=m))
            n_guarded = len(calls)
            with faults.active("hop.exchange:corrupt"):
                try:
                    pat.transpose(x, pout, method=m)
                    kind = None
                except IntegrityError as e:
                    kind = e.kind
            guard.disable()
            faults.clear()
            with faults.active("hop.exchange:corrupt"):
                poked = to_numpy_padded(pat.transpose(x, pout, method=m))
            faults.clear()
            out.append(dict(plain=plain, guarded=guarded, poked=poked,
                            kinds=_on_every_rank(topo, kind),
                            hops=(n_plain, n_guarded)))
    finally:
        tr._hop = orig
        guard._reset_for_tests()
        faults.clear()
    return _rank0(out)


def guard_route_case(dims, shape, src, dest, u, method, tmp):
    """A routed reshard guarded (bits, and the corrupt drill's kind on
    every rank) and unguarded (the poke flows through)."""
    from pencilarrays_tpu_torch import guard
    from pencilarrays_tpu_torch.guard import IntegrityError
    from pencilarrays_tpu_torch.resilience import faults

    topo = sub_topology(dims)
    if topo is None:
        return None
    pin = _sub_pencil(topo, shape, *src)
    pout = _sub_pencil(topo, shape, *dest)
    x = pat.PencilArray.from_global(pin, u)
    try:
        plain = to_numpy_padded(pat.reshard(x, pout, method=method))
        guard.enable(tmp)
        guarded = to_numpy_padded(pat.reshard(x, pout, method=method))
        with faults.active("hop.exchange:corrupt"):
            try:
                pat.reshard(x, pout, method=method)
                kind = None
            except IntegrityError as e:
                kind = e.kind
        guard.disable()
        faults.clear()
        with faults.active("hop.exchange:corrupt"):
            poked = to_numpy_padded(pat.reshard(x, pout, method=method))
    finally:
        guard._reset_for_tests()
        faults.clear()
    return _rank0(dict(plain=plain, guarded=guarded, poked=poked,
                       kinds=_on_every_rank(topo, kind)))


def straggler_case(dims, shape, jdir, hops=3, delay_s=0.25):
    """Every rank journals ``hops`` local-permute hops (no collective, so
    one rank's stall is its own) with ``hop.exchange:delay%rank1``
    armed; rank 0 merges the journals and runs the offline straggler
    rule.  Returns the merged timeline's ranks and warnings and the
    flags."""
    import os

    from pencilarrays_tpu_torch import obs
    from pencilarrays_tpu_torch.obs import events as obs_events
    from pencilarrays_tpu_torch.obs.straggler import detect_from_events
    from pencilarrays_tpu_torch.resilience import faults

    topo = sub_topology(dims)
    if topo is None:
        return None
    pin = _sub_pencil(topo, shape, (0, 1), None)
    pout = _sub_pencil(topo, shape, (0, 1), (2, 0, 1))
    x = pat.PencilArray.from_global(pin, np.zeros(shape))
    old = os.environ.get(faults.DELAY_S_VAR)
    os.environ[faults.DELAY_S_VAR] = str(delay_s)
    obs_events._reset_for_tests()
    obs.enable(jdir)
    try:
        with faults.active("hop.exchange:delay%rank1"):
            for _ in range(hops):
                pat.transpose(x, pout)
    finally:
        obs.disable()
        faults.clear()
        if old is None:
            os.environ.pop(faults.DELAY_S_VAR, None)
        else:
            os.environ[faults.DELAY_S_VAR] = old
    torch.distributed.barrier(group=topo.group)
    if torch.distributed.get_rank() != 0:
        return None
    tl = obs.merge_journals(jdir)
    return dict(ranks=tl.ranks, warnings=tl.warnings,
                flags=detect_from_events(tl.events))


def drift_case(dims, shape, jdir):
    """With observability on: one hop (a ``dispatch`` drift sample, a
    ``hop`` record), then ``measure_transpose`` of the same hop (a
    ``benchtime`` sample that outranks it).  Returns rank 0's drift
    reports after each, and its journal's event names."""
    from pencilarrays_tpu_torch import obs
    from pencilarrays_tpu_torch.obs import drift
    from pencilarrays_tpu_torch.obs import events as obs_events

    topo = sub_topology(dims)
    if topo is None:
        return None
    pin = _sub_pencil(topo, shape, (1, 2), None)
    pout = _sub_pencil(topo, shape, (0, 2), None)
    x = pat.PencilArray.zeros(pin, dtype=torch.float32)
    drift.drift_tracker.reset()
    obs_events._reset_for_tests()
    obs.enable(jdir)
    try:
        pat.transpose(x, pout)
        after_hop = drift.drift_report()
        measured = drift.measure_transpose(x, pout, k0=1, k1=2, repeats=1)
        after_measure = obs.snapshot()["drift"]
    finally:
        obs.disable()
        drift.drift_tracker.reset()
    events = [e["ev"] for e in obs.read_journal(jdir)
              if e.get("proc") == torch.distributed.get_rank()]
    return _rank0(dict(after_hop=after_hop, measured=measured,
                       after_measure=after_measure, events=events))


def store_kv_case(ns):
    """The cluster layer's wire on the pool's default store: every rank
    resolves ``PENCILARRAYS_TPU_CLUSTER=1`` to a ``StoreKV`` over it and
    the ranks agree one verdict in namespace ``ns`` (rank 3 failing)."""
    from pencilarrays_tpu_torch.cluster.consensus import Coordinator
    from pencilarrays_tpu_torch.cluster.kv import StoreKV, resolve_kv

    from pencilarrays_tpu_torch.cluster import epoch

    dist = torch.distributed
    kv = resolve_kv("1")
    assert isinstance(kv, StoreKV)
    rank, world = dist.get_rank(), dist.get_world_size()
    c = Coordinator(kv, rank, world, lease_ttl=30.0, verdict_timeout=60.0,
                    namespace=ns)
    try:
        status = {"status": "integrity" if rank == 3 else "ok",
                  "can_retry": True, "can_restore": False,
                  "error": "sdc" if rank == 3 else None}
        v = c.agree("store", status)
        steps = c.agree_steps("ck", [1, 2, rank + 3])
    finally:
        c.shutdown()
        # the agreed retry advanced this pool process's recovery epoch,
        # which later cases' checkpoint manifests would carry
        epoch._reset_for_tests()
    return {"action": v["action"], "ranks": v["ranks"], "round": v["round"],
            "steps": steps}


def serve_scenario(dims, name, args, tmp, every=False):
    """One scenario of ``tests/torch_serve_scenarios.py`` through the
    port on the first ``prod(dims)`` ranks of the pool (each rank its own
    ``PlanService``, the same submissions), in ``tmp/r<rank>``; rank 0's
    result (``None`` from the other ranks), or with ``every`` each
    rank's own."""
    import pathlib

    import torch_serve_scenarios as S

    topo = sub_topology(dims)
    if topo is None:
        return None
    d = pathlib.Path(tmp) / f"r{torch.distributed.get_rank()}"
    d.mkdir(parents=True, exist_ok=True)
    P = S.SPkg("torch", topo=lambda want: sub_topology(want))
    P.reset()
    try:
        out = S.SCENARIOS[name](P, *[d if a == "<tmp>" else a
                                     for a in args])
    finally:
        P.reset()
    return out if every or P.rank0() else None


def fleet_mesh_case(kvroot, mesh, max_seconds, fault=""):
    """One fleet mesh of every rank of the pool: each rank its own
    ``PlanService`` (the JAX fleet worker's ``minnow`` and ``whale`` c2c
    plans on a ``(P, 1)`` topology) behind a ``MeshWorker`` over the
    ``FileKV`` at ``kvroot``; rank 0 speaks for the mesh.  Serves until
    the mesh's stop key (or ``max_seconds``), under the fault rules
    ``fault``; every rank's counts."""
    from pencilarrays_tpu_torch.cluster.kv import FileKV
    from pencilarrays_tpu_torch.fleet import MeshWorker
    from pencilarrays_tpu_torch.resilience import faults
    from pencilarrays_tpu_torch.serve import PlanService

    faults.install(fault)

    topo = pat.Topology((torch.distributed.get_world_size(), 1),
                        device="cpu")
    svc = PlanService(max_batch=4, max_wait_s=0.0)
    svc.register_plan("minnow", lambda ctx: pat.PencilFFTPlan(
        topo, (8, 6, 4)))
    svc.register_plan("whale", lambda ctx: pat.PencilFFTPlan(
        topo, (16, 12, 8)))
    w = MeshWorker(FileKV(kvroot), mesh, service=svc, ttl=2.0)
    w.prewarm(["minnow", "whale"])
    w.start()
    try:
        w.run(poll_s=0.01, max_seconds=max_seconds)
    finally:
        svc.close()
        faults.clear()
    return {"handled": w.handled, "stopped": w.stopped,
            "depth": svc.queue.depth()}


# -- the static analysis (analysis/spmd.py) -----------------------------------

def _ops(trace):
    return [[o.kind, o.bytes] for o in trace.ops]


def _method(name):
    return {"alltoall": pat.AllToAll(), "ring": pat.Ring(),
            "pipelined": pat.Pipelined(chunks=2)}[name]


def analysis_case(name, *args):
    """One case of the JAX package's ``tests/test_analysis.py`` pillar 1
    on the pool's ranks (every rank traces; each asserts the port's trace
    against the port's own prediction); rank 0's comparable values."""
    from pencilarrays_tpu_torch.analysis import spmd

    out = globals()["_an_" + name](spmd, *args)
    return out if torch.distributed.get_rank() == 0 else None


def _an_transpose(spmd, method, extra):
    topo = sub_topology((4,))
    if topo is None:
        return None
    pin = pat.Pencil(topo, (16, 12, 20), (1,))
    pout = pat.Pencil(topo, (16, 12, 20), (0,))
    m = _method(method)
    tr = spmd.trace_transpose(pin, pout, tuple(extra), torch.complex64, m)
    pred = pat.transpose_cost(pin, pout, tuple(extra), torch.complex64, m)
    assert tr.stats() == pred, (tr.stats(), pred)
    assert all(o.bytes > 0 for o in tr.ops)
    assert [o.index for o in tr.ops] == list(range(len(tr.ops)))
    assert any(o.replica_groups for o in tr.ops)
    return {"stats": tr.stats(), "pred": pred, "ops": _ops(tr)}


def _an_plan(spmd, dims, real, extra):
    topo = sub_topology(tuple(dims))
    if topo is None:
        return None
    plan = pat.PencilFFTPlan(topo, (8, 8, 4), real=real)
    fwd = spmd.verify_plan(plan, tuple(extra), "forward")
    bwd = spmd.verify_plan(plan, tuple(extra), "backward")
    assert len(fwd) > 0 and len(bwd) > 0
    return {"pred": plan.collective_costs(tuple(extra)),
            "fwd": _ops(fwd), "bwd": _ops(bwd)}


def _route8(dest_decomp=(0, 1)):
    from pencilarrays_tpu_torch.parallel.routing import plan_reshard_route

    topo = sub_topology((2, 4))
    pin = pat.Pencil(topo, (16, 12, 8), (1, 2))
    dest = pat.Pencil(topo, (16, 12, 8), dest_decomp)
    return plan_reshard_route(pin, dest, (), torch.float32)


def _an_routed(spmd):
    route = _route8()
    assert route.hops
    tr = spmd.verify_route(route, (), torch.float32)
    assert len(tr) == sum(c["count"] for h in route.hops
                          for c in h.cost.values())
    return {"ops": _ops(tr), "costs": [h.cost for h in route.hops],
            "verdict": route.verdict}


def _an_compiled(spmd):
    topo = sub_topology((2, 2))
    if topo is None:
        return None
    plan = pat.PencilFFTPlan(topo, (8, 8, 4), dtype=torch.complex64,
                             batch=3)
    cp = plan.compile()
    f = spmd.trace_compiled_plan(cp, "forward")
    b = spmd.trace_compiled_plan(cp, "backward")
    pred = plan.collective_costs((3,))
    assert f.stats() == pred and b.stats() == pred
    return {"pred": pred, "fwd": _ops(f), "bwd": _ops(b)}


def _an_corrupted(spmd):
    from pencilarrays_tpu_torch.analysis.errors import ScheduleMismatchError

    topo = sub_topology((2, 2))
    if topo is None:
        return None
    plan = pat.PencilFFTPlan(topo, (8, 8, 4), dtype=torch.complex64)
    good = spmd.trace_plan(plan, ())
    assert good.ops
    corrupted = spmd.CollectiveTrace(source="corrupted", ops=good.ops[:-1],
                                     donated_params=good.donated_params)
    out = {}
    try:
        spmd.verify_plan(plan, (), "forward", trace=corrupted)
        raise AssertionError("a dropped collective certified")
    except ScheduleMismatchError as e:
        assert e.op == good.ops[-1].kind and e.predicted is not None
        assert good.ops[-1].kind in str(e)
        out["dropped"] = [e.op, e.predicted, e.observed]
    real_costs = plan.collective_costs

    def tampered(extra_dims=None, **kw):
        costs = real_costs(extra_dims, **kw)
        op = next(iter(costs))
        costs[op] = {"count": costs[op]["count"] + 1,
                     "bytes": costs[op]["bytes"]}
        return costs

    plan.collective_costs = tampered
    try:
        spmd.verify_plan(plan, (), "forward", trace=good)
        raise AssertionError("a tampered prediction certified")
    except ScheduleMismatchError as e:
        assert e.op in good.stats()
        out["tampered"] = [e.op, e.predicted, e.observed]
    finally:
        del plan.collective_costs
    return out


def _an_hbm(spmd):
    from pencilarrays_tpu_torch.analysis.errors import HbmBoundError

    topo = sub_topology((2, 2))
    route = _route8()
    out = None
    if topo is not None:
        plan = pat.PencilFFTPlan(topo, (8, 8, 4), dtype=torch.complex64)
        peak, label = spmd.predicted_peak_hbm(plan)
        assert peak > 0 and label.startswith("hop[")
        assert spmd.verify_hbm(plan, peak) == peak
        try:
            spmd.verify_hbm(plan, peak - 1, source="drill")
            raise AssertionError("over the bound certified")
        except HbmBoundError as e:
            assert e.hop == label and e.peak_bytes == peak
            assert "drill" in str(e) and label in str(e)
        out = {"plan": [peak, label]}
    rpeak, rlabel = spmd.predicted_peak_hbm(route)
    assert rpeak == max(h.peak_hbm_bytes for h in route.hops)
    try:
        spmd.verify_hbm(route, rpeak - 1)
        raise AssertionError("over the bound certified")
    except HbmBoundError as e:
        assert e.hop == rlabel and rlabel.startswith("route[")
    if out is not None:
        out["route"] = [rpeak, rlabel]
    return out


def _an_consistency(spmd):
    import tempfile

    from pencilarrays_tpu_torch import guard
    from pencilarrays_tpu_torch.analysis.errors import TraceDivergenceError

    topo = sub_topology((2, 2))
    if topo is None:
        return None
    plan = pat.PencilFFTPlan(topo, (8, 8, 4), dtype=torch.complex64)
    t1 = spmd.trace_plan(plan, ())
    t3 = spmd.trace_plan(plan, (3,))
    spmd.verify_consistent(t1, t3, bytes_ratio=3)
    try:
        spmd.verify_consistent(t1, t3, bytes_ratio=1)
        raise AssertionError("a wrong ratio certified")
    except TraceDivergenceError as e:
        assert e.op in t1.stats()
        div = e.op
    pin = pat.Pencil(topo, (8, 8, 4), (1, 2))
    pout = pat.Pencil(topo, (8, 8, 4), (0, 2))
    off = spmd.trace_transpose(pin, pout, (), torch.float32)
    with tempfile.TemporaryDirectory() as d:
        guard.enable(d)
        try:
            on = spmd.trace_transpose(pin, pout, (), torch.float32)
        finally:
            guard._reset_for_tests()
    spmd.verify_consistent(off, on)
    return {"t1": _ops(t1), "t3": _ops(t3), "div": div,
            "off": _ops(off),
            "on_exchange": [o for o in _ops(on)
                            if o[0] in spmd.EXCHANGE_KINDS]}


def _an_donation(spmd):
    from pencilarrays_tpu_torch.analysis.errors import DonationError

    route = _route8()
    donated = spmd.trace_route(route, (), torch.float32, donate=True)
    spmd.verify_donation(donated)
    assert 0 in donated.donated_params
    plain = spmd.trace_route(route, (), torch.float32, donate=False)
    try:
        spmd.verify_donation(plain)
        raise AssertionError("a held operand certified as donated")
    except DonationError:
        pass
    return {"donated": list(donated.donated_params),
            "plain": list(plain.donated_params)}


def _an_certify_sweep(spmd, tmp):
    import os

    from pencilarrays_tpu_torch import obs
    from pencilarrays_tpu_torch.cluster import elastic
    from pencilarrays_tpu_torch.obs.schema import lint_journal
    from pencilarrays_tpu_torch.serve.service import PlanService

    topo = sub_topology((2, 2))
    if topo is None:
        return None
    jdir = os.path.join(tmp, f"r{torch.distributed.get_rank()}")
    obs.enable(jdir)
    svc = PlanService(max_batch=4)
    try:
        svc.register_plan("c2c", lambda ctx: pat.PencilFFTPlan(
            topo, (8, 8, 4), dtype=torch.complex64))
        svc.register_plan("r2c", lambda ctx: pat.PencilFFTPlan(
            topo, (8, 8, 4), real=True))
        svc.registry.compiled(svc.plan("c2c"), (2,))
        report = svc.certify()
        keys = {n: svc.plan(n).plan_key() for n in ("c2c", "r2c")}
    finally:
        svc.close()
        obs.disable()
        elastic.unregister_plan("serve:c2c")
        elastic.unregister_plan("serve:r2c")
    assert report["ok"] and report["certified"] >= 2
    assert all(r["outcome"] == "ok" for r in report["plans"])
    targets = {r["target"] for r in report["plans"]}
    assert {f"serve:{k}" for k in keys.values()} <= targets
    events = [e for e in obs.read_journal(jdir)
              if e["ev"] == "analysis.check"]
    assert len(events) == report["certified"]
    assert all(e["outcome"] == "ok" and e["seconds"] >= 0 for e in events)
    assert lint_journal(obs.read_journal(jdir)) == []
    return {"ok": report["ok"], "certified": report["certified"],
            "targets": sorted(targets), "keys": keys,
            "plans": sorted([r["target"], r["extra_dims"], r["ops"],
                             r["predicted_bytes"]]
                            for r in report["plans"])}


def _an_certify_hbm(spmd):
    from pencilarrays_tpu_torch.analysis.errors import HbmBoundError
    from pencilarrays_tpu_torch.serve.service import PlanService

    topo = sub_topology((2, 2))
    if topo is None:
        return None
    svc = PlanService()
    plan = pat.PencilFFTPlan(topo, (8, 8, 4), dtype=torch.complex64)
    svc.registry.register(plan)
    svc.registry.compiled(plan, (16,))
    try:
        unbatched, _ = spmd.predicted_peak_hbm(plan, ())
        batched, _ = spmd.predicted_peak_hbm(plan, (16,))
        assert batched > unbatched
        try:
            svc.certify(hbm_limit=unbatched)
            raise AssertionError("the batched variant escaped the limit")
        except HbmBoundError:
            pass
        report = svc.certify(hbm_limit=unbatched, raise_on_error=False)
        assert not report["ok"]
        bad = [r for r in report["plans"]
               if r["outcome"] == "HbmBoundError"]
        assert len(bad) == 1 and bad[0]["extra_dims"] == [16]
        assert "error" in bad[0]
        assert svc.certify(hbm_limit=batched)["ok"]
    finally:
        svc.close()
    return {"peaks": [unbatched, batched], "bad": bad[0]["extra_dims"]}


def _an_certify_failure(spmd, tmp):
    import os

    from pencilarrays_tpu_torch import obs
    from pencilarrays_tpu_torch.analysis.errors import ScheduleMismatchError

    topo = sub_topology((2, 2))
    if topo is None:
        return None
    jdir = os.path.join(tmp, f"r{torch.distributed.get_rank()}")
    obs.enable(jdir)
    plan = pat.PencilFFTPlan(topo, (8, 8, 4), dtype=torch.complex64)
    real_costs = plan.collective_costs
    good = spmd.trace_plan(plan, ())
    op = next(iter(good.stats()))

    def tampered(extra_dims=None, **kw):
        costs = real_costs(extra_dims, **kw)
        costs[op] = {"count": costs[op]["count"] + 1,
                     "bytes": costs[op]["bytes"]}
        return costs

    plan.collective_costs = tampered
    try:
        spmd.certify_plan(plan, (), target="drill")
        raise AssertionError("a tampered schedule certified")
    except ScheduleMismatchError as e:
        assert e.op == op
    finally:
        obs.disable()
    events = [e for e in obs.read_journal(jdir)
              if e["ev"] == "analysis.check"]
    assert len(events) == 1
    assert events[0]["outcome"] == "ScheduleMismatchError"
    assert events[0]["target"] == "drill"
    return {"op": op, "outcome": events[0]["outcome"]}


def _an_certify_engine(spmd):
    from pencilarrays_tpu_torch.engine import Engine
    from pencilarrays_tpu_torch.serve import PlanService

    topo = sub_topology((2,))
    if topo is None:
        return None
    plan = pat.PencilFFTPlan(topo, (8, 6, 4))
    rng = np.random.default_rng(3)
    engine = Engine("certify", workers=2)
    svc = PlanService(max_batch=4, max_wait_s=0.0, engine=engine)
    try:
        for _ in range(8):
            svc.submit("t0", (rng.standard_normal((8, 6, 4))
                              + 1j * rng.standard_normal((8, 6, 4))
                              ).astype(np.complex64), plan=plan)
        svc.drain()
        report = svc.certify(engine=True)
    finally:
        svc.close()
        engine.close()
    assert report["ok"] and report["engine"]["order_ok"]
    e = report["engine"]
    assert e["dispatches"] == 2 and e["verified_traces"] == 2
    assert e["unverified"] == 0
    return {k: e[k] for k in ("dispatches", "verified_traces",
                              "unverified", "mode", "wire_checked", "ops")}


# -- a service across a scale-down and a rejoin -------------------------------

def scale_rejoin_role(role, tmp, out, left, down):
    """One process of the scale-down-and-rejoin serve drill (a process of
    its own, not a pool rank).  ``survivor`` and ``leaver`` form a world
    of two gloo ranks and serve three requests through one
    ``PlanService`` each; the leaver leaves the cluster (``left``), the
    survivor reforms down to one rank and serves alone (``down``), then
    admits ``joiner``, a fresh process, by a second reformation and the
    two serve again.  A process group cannot shrink or grow, so each
    reformation makes a new one: the first factory it re-invokes joins
    the new world.  Each process puts ``(role, result)`` on ``out``:
    the worlds it served on and, on the serving world's rank 0, each
    result's error relative to ``numpy.fft.fftn``."""
    import torch.distributed as dist

    from pencilarrays_tpu_torch.cluster import elastic
    from pencilarrays_tpu_torch.cluster.consensus import Coordinator
    from pencilarrays_tpu_torch.cluster.kv import FileKV
    from pencilarrays_tpu_torch.parallel.gather import gather
    from pencilarrays_tpu_torch.serve import PlanService

    torch.set_num_threads(1)
    kv = FileKV(os.path.join(tmp, "kv"))
    shape = (8, 6, 4)

    def join_world(gen, world, rank):
        pat.distributed.finalize()
        pat.distributed.initialize(
            "gloo", init_method=f"file://{tmp}/pg.g{gen}", world_size=world,
            rank=rank, timeout_s=60)

    def regroup(ctx):
        join_world(ctx.membership.gen, ctx.membership.new_world,
                   ctx.membership.new_rank)

    def factory(ctx=None):
        topo = pat.Topology((dist.get_world_size(), 1), device="cpu")
        return pat.PencilFFTPlan(topo, shape)

    def serve(svc, seed):
        rng = np.random.default_rng(seed)
        us = [(rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
               ).astype(np.complex64) for _ in range(3)]
        tickets = [svc.submit("acme", u, name="fft") for u in us]
        svc.drain()
        errs = []
        for u, t in zip(us, tickets):
            got = gather(t.result(0))
            if dist.get_rank() == 0:
                ref = np.fft.fftn(u)
                errs.append(float(np.abs(got - ref).max()
                                  / np.abs(ref).max()))
        return [dist.get_world_size(), errs]

    svc = coord = None
    try:
        if role == "joiner":
            r = elastic.request_join(kv, "spare", namespace="pa",
                                     timeout=60)
            coord = r.coordinator
            join_world(r.membership.gen, r.membership.new_world,
                       r.membership.new_rank)
            svc = PlanService(max_batch=4, max_wait_s=60.0)
            svc.register_plan("fft", factory)
            out.put((role, [serve(svc, 3)]))
            return
        rank = 0 if role == "survivor" else 1
        join_world(0, 2, rank)
        coord = Coordinator(kv, rank, 2, lease_ttl=1.0, verdict_timeout=30)
        elastic.register_plan("regroup", regroup)
        svc = PlanService(max_batch=4, max_wait_s=60.0)
        svc.register_plan("fft", factory)
        served = [serve(svc, 1)]
        if role == "leaver":
            svc.close()
            svc = None
            coord.leave()
            pat.distributed.finalize()
            left.set()
            out.put((role, served))
            return
        assert left.wait(60), "the leaver never left"
        coord = elastic.reform(coord, reason="scale-down",
                               install=True).coordinator
        served.append(serve(svc, 2))
        down.set()
        kv.get("pa/join/sspare", 60.0)
        coord = elastic.reform(coord, reason="scale-up",
                               install=True).coordinator
        served.append(serve(svc, 3))
        out.put((role, served))
    except BaseException:
        import traceback

        out.put((role, traceback.format_exc()))
        raise
    finally:
        if svc is not None:
            svc.close()
        if coord is not None:
            coord.shutdown()
        pat.distributed.finalize()


def example_case(name, kwargs):
    """``run(device="cpu", **kwargs)`` of the port's example ``name`` on
    every rank of the pool; rank 0's result."""
    import importlib

    mod = importlib.import_module(f"pencilarrays_tpu_torch.examples.{name}")
    return _rank0(mod.run(device="cpu", **kwargs))


def dryrun_case(n):
    """The port's dry run on every rank of a pool of ``n``; every rank's
    result."""
    from pencilarrays_tpu_torch.entry import dryrun

    return dryrun(n, device="cpu")


def spans_case(names, n=16):
    """A 16^3 NS step, a round trip of its plan and an ``AllToAll()``
    x -> y -> z -> y -> x cycle on a one-rank topology, run once plain
    and once under ``torch.profiler`` (CPU): the profile's ranges of the
    spans ``names`` as ``(name, start ns, end ns, thread)``, and whether
    every output of the profiled run is bit-identical to the plain
    run's."""
    from torch.profiler import ProfilerActivity, profile

    topo = topology((1, 1))
    model = NavierStokesSpectral(topo, (n, n, n), viscosity=1e-2)
    gen = torch.Generator().manual_seed(0)
    uh = model.allocate_state()
    uh = pat.PencilArray(uh.pencil, torch.randn(
        uh.data.shape, dtype=uh.data.dtype, generator=gen), (3,))
    u = pat.PencilArray(model.plan.input_pencil, torch.randn(
        model.plan.allocate_input((3,)).data.shape, generator=gen), (3,))
    specs = {"x": ((1, 2), (1, 2, 0)), "y": ((0, 2), (0, 2, 1)),
             "z": ((0, 1), (0, 1, 2))}
    pens = [pencil((1, 1), (n, n, n), specs[p]) for p in "xyzyx"]
    x = pat.PencilArray(pens[0], torch.randn(
        pens[0].padded_size_local(pat.MemoryOrder), generator=gen))

    def run():
        outs = [model.step(uh, 1e-3).data]
        uh2 = model.plan.forward(u)
        outs += [uh2.data, model.plan.backward(uh2).data]
        v = x
        for pen in pens[1:]:
            v = pat.transpose(v, pen, method=pat.AllToAll())
            outs.append(v.data)
        return outs

    plain = run()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = run()
    same = [a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8),
        b.contiguous().reshape(-1).view(torch.uint8))
        for a, b in zip(plain, traced)]
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
              e.start_thread_id())
             for e in prof.profiler.kineto_results.events()
             if e.name() in names]
    return _rank0({"spans": spans, "same": same})
