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
