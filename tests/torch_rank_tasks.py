"""Functions the PyTorch-port tests run on every rank of a gloo pool.

Imported by the pool's rank processes, so it imports torch, NumPy and the
port only — never JAX.  Every function takes plain data (NumPy arrays,
tuples describing pencils) and returns NumPy results from rank 0 (``None``
from the other ranks).  Pencils are described as ``(decomp_dims, perm)``
with ``perm`` a tuple or ``None``.
"""

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

    from pencilarrays_tpu_torch.parallel.topology import _axis_lines

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
                    for line in _axis_lines(dims, axis):
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
