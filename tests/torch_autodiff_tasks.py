"""Rank functions of ``tests/test_torch_autodiff.py``: gradients through
the port on ranks of the shared gloo pool.

Imported by the pool's rank processes, so it imports torch, NumPy and the
port only — never JAX.  Every function builds its topology over the
pool's first ranks (``torch_rank_tasks.sub_topology``) and returns NumPy
results from rank 0 (``None`` from the other ranks).

``card_k1`` puts kernel K1 on its card path while CPU tensors run it:
``permute._check`` answers ``"cuda"`` and ``permute.run_plan`` executes
each plan by ``permute.emulate`` and counts it, so a K1 call that autograd
cannot see on the card cannot be seen here either.
"""

import contextlib
import math

import torch

import pencilarrays_tpu_torch as pat
from pencilarrays_tpu_torch.interop import from_numpy_padded, to_numpy_padded
from pencilarrays_tpu_torch.ops import permute as k1
from torch_rank_tasks import _rank0, _sub_pencil, sub_topology


@contextlib.contextmanager
def card_k1():
    """K1's launch path as on the card, for CPU tensors (module
    docstring); ``permute.recorded`` collects the classes launched."""
    check, run = k1._check, k1.run_plan

    def as_card(x, out=None, out_shape=None):
        check(x, out, out_shape)
        return "cuda"

    def emulated(plan, x, out):
        k1.emulate(plan, x, x.dtype, out=out)
        k1.launches += 1
        k1.launches_by_instance[plan.instance] += 1
        k1.bytes_moved += (x.numel() + out.numel()) * x.element_size()

    k1._check, k1.run_plan, k1.recorded = as_card, emulated, {}
    try:
        yield
    finally:
        k1._check, k1.run_plan, k1.recorded = check, run, None


def _kinds():
    """K1 launches so far by kind (``permute``, ``pack``, ``unpack``)."""
    out = {}
    for key, n in (k1.recorded or {}).items():
        out[key[0]] = out.get(key[0], 0) + n
    return out


def _minus(a, b):
    return {k: a.get(k, 0) - b.get(k, 0) for k in set(a) | set(b)
            if a.get(k, 0) != b.get(k, 0)}


def _method(name):
    return {"AllToAll": pat.AllToAll, "Ring": pat.Ring,
            "Gspmd": pat.Gspmd}[name]()


def _leaf(x):
    return x.data.clone().requires_grad_()


def _grad_global(pen, leaf, extra=()):
    g = pat.PencilArray(pen, leaf.grad, tuple(extra))
    return pat.gather(g), to_numpy_padded(g)


def grad_transpose_case(dims, shape, spec_a, spec_b, u, method):
    """Gradient of ``sum(v * v)`` for ``v`` the transpose (or, with
    ``method`` ``"reshard"``, the ``reshard``) of ``u`` from ``spec_a`` to
    ``spec_b``: gathered and padded."""
    topo = sub_topology(dims)
    if topo is None:
        return None
    pa, pb = (_sub_pencil(topo, shape, *s) for s in (spec_a, spec_b))
    leaf = _leaf(pat.PencilArray.from_global(pa, u))
    x = pat.PencilArray(pa, leaf)
    v = (pat.reshard(x, pb) if method == "reshard"
         else pat.transpose(x, pb, method=_method(method)))
    pat.ops.sum(v * v).backward()
    return _rank0(_grad_global(pa, leaf))


def jvp_transpose_case(dims, shape, spec_a, spec_b, u, t):
    """The JVP of the transpose at ``u`` along ``t`` by a double backward
    (``v -> J^T v`` differentiated in ``v``), and the transpose of ``t``:
    both as padded global arrays of the destination."""
    topo = sub_topology(dims)
    if topo is None:
        return None
    pa, pb = (_sub_pencil(topo, shape, *s) for s in (spec_a, spec_b))
    leaf = _leaf(pat.PencilArray.from_global(pa, u))
    tx = pat.PencilArray.from_global(pa, t)
    y = pat.transpose(pat.PencilArray(pa, leaf), pb).data
    v = torch.zeros_like(y, requires_grad=True)
    (jt_v,) = torch.autograd.grad(y, leaf, v, create_graph=True)
    (dy,) = torch.autograd.grad(jt_v, v, tx.data)
    return _rank0((to_numpy_padded(pat.PencilArray(pb, dy)),
                   to_numpy_padded(pat.transpose(tx, pb))))


def _fft_power(plan, leaf):
    uh = plan.forward(pat.PencilArray(plan.input_pencil, leaf))
    return pat.ops.sum(pat.PencilArray(uh.pencil, uh.data.abs() ** 2,
                                       uh.extra_dims))


def grad_fft_case(dims, shape, u, w=None, remat=False):
    """Through an r2c float64 plan: the gradient of ``sum|F u|^2`` (and,
    ``remat``, the same under ``torch.utils.checkpoint``), or with ``w``
    that of ``sum(backward(forward(u)) * w)``; gathered."""
    from torch.utils.checkpoint import checkpoint

    topo = sub_topology(dims)
    if topo is None:
        return None
    plan = pat.PencilFFTPlan(topo, shape, real=True, dtype=torch.float64)
    pen = plan.input_pencil
    x = pat.PencilArray.from_global(pen, u)
    out = []
    for rc in ((False, True) if remat else (False,)):
        leaf = _leaf(x)
        if w is not None:
            wx = pat.PencilArray.from_global(pen, w)
            rt = plan.backward(plan.forward(pat.PencilArray(pen, leaf)))
            loss = pat.ops.sum(rt * wx)
        elif rc:
            loss = checkpoint(lambda d: _fft_power(plan, d), leaf,
                              use_reentrant=False)
        else:
            loss = _fft_power(plan, leaf)
        loss.backward()
        out.append(_grad_global(pen, leaf)[0])
    return _rank0(out)


def arith_stack(pkg, a, pen_y):
    """``PencilArray`` arithmetic, ``PencilArray.stack`` of three
    components, a transpose of the stack, then sum(v * v): written once
    for both packages (``pkg`` is either's top module)."""
    s = pkg.PencilArray.stack([a * 2.0, a * a, 1.0 - a])
    v = pkg.transpose(s, pen_y)
    return pkg.ops.sum(v * v)


def grad_arith_stack_case(dims, shape, spec_a, spec_y, u):
    """The padded global gradient of :func:`arith_stack`."""
    topo = sub_topology(dims)
    if topo is None:
        return None
    pa, py = (_sub_pencil(topo, shape, *s) for s in (spec_a, spec_y))
    leaf = _leaf(pat.PencilArray.from_global(pa, u))
    arith_stack(pat, pat.PencilArray(pa, leaf), py).backward()
    return _rank0(to_numpy_padded(pat.PencilArray(pa, leaf.grad)))


def grad_norm_case(dims, shape, spec, u):
    """``norm`` differentiated through ``x.data`` with the gradient
    returned on ``x.pencil``: whether the pencil is the input's, and the
    gathered gradient."""
    topo = sub_topology(dims)
    if topo is None:
        return None
    pen = _sub_pencil(topo, shape, *spec)
    x = pat.PencilArray.from_global(pen, u)
    leaf = _leaf(x)
    pat.ops.norm(pat.PencilArray(x.pencil, leaf)).backward()
    g = pat.PencilArray(x.pencil, leaf.grad)
    return _rank0((g.pencil == pen, pat.gather(g)))


def grad_reductions_case(dims, shape, spec, u, v):
    """Padded global gradients of ``sum(a * a)``, ``mean(a)``,
    ``norm(a)``, ``dot(a, v)``, ``maximum(a)`` and ``prod(0.1 a + 1)``
    with respect to ``a``'s data."""
    topo = sub_topology(dims)
    if topo is None:
        return None
    pen = _sub_pencil(topo, shape, *spec)
    x = pat.PencilArray.from_global(pen, u)
    vx = pat.PencilArray.from_global(pen, v)
    out = {}
    for name, f in (("sum", lambda a: pat.ops.sum(a * a)),
                    ("mean", pat.ops.mean), ("norm", pat.ops.norm),
                    ("dot", lambda a: pat.ops.dot(a, vx)),
                    ("maximum", pat.ops.maximum),
                    ("prod", lambda a: pat.ops.prod(a * 0.1 + 1.0))):
        leaf = _leaf(x)
        f(pat.PencilArray(pen, leaf)).backward()
        out[name] = to_numpy_padded(pat.PencilArray(pen, leaf.grad))
    return _rank0(out)


def grad_extrema_case(dims, shape, spec, u):
    """Padded global gradients of ``maximum(a)``, ``minimum(a)`` and
    ``norm(a, inf)`` with respect to ``a``'s data (``u`` holds ties
    across ranks)."""
    topo = sub_topology(dims)
    if topo is None:
        return None
    pen = _sub_pencil(topo, shape, *spec)
    x = pat.PencilArray.from_global(pen, u)
    out = {}
    for name, f in (("maximum", pat.ops.maximum),
                    ("minimum", pat.ops.minimum),
                    ("norm_inf", lambda a: pat.ops.norm(a, math.inf))):
        leaf = _leaf(x)
        f(pat.PencilArray(pen, leaf)).backward()
        out[name] = to_numpy_padded(pat.PencilArray(pen, leaf.grad))
    return _rank0(out)


def _ns(topo, n, nu):
    from pencilarrays_tpu_torch.models import NavierStokesSpectral

    return NavierStokesSpectral(topo, n, viscosity=nu, dtype=torch.float64)


def grad_ns_case(dims, n, nu, dt, uh0_padded, d_padded, eps, remat=False):
    """One RK2 step from the JAX package's state: the padded global
    gradient of ``sum|step(uh).data|^2``, the loss at ``uh0 +- eps d``
    and, ``remat``, the gradient under ``torch.utils.checkpoint``."""
    from torch.utils.checkpoint import checkpoint

    topo = sub_topology(dims)
    if topo is None:
        return None
    model = _ns(topo, n, nu)
    pen = model.plan.output_pencil
    uh0 = from_numpy_padded(pen, uh0_padded, (3,))
    d = from_numpy_padded(pen, d_padded, (3,)).data

    def loss(data):
        out = model.step(pat.PencilArray(pen, data, (3,)), dt)
        return _all_sum(out.data.abs() ** 2, topo)

    res = {}
    for rc in ((False, True) if remat else (False,)):
        leaf = uh0.data.clone().requires_grad_()
        (checkpoint(loss, leaf, use_reentrant=False) if rc
         else loss(leaf)).backward()
        res["remat" if rc else "grad"] = to_numpy_padded(
            pat.PencilArray(pen, leaf.grad, (3,)))
    with torch.no_grad():
        res["lp"] = float(loss(uh0.data + eps * d))
        res["lm"] = float(loss(uh0.data - eps * d))
    return _rank0(res)


def _all_sum(t, topo):
    """The sum over every rank's padded block (the JAX package's
    ``jnp.sum`` over ``.data``), differentiable: a local sum combined by
    ``reductions``' all-reduce."""
    from pencilarrays_tpu_torch.ops import reductions

    local = t.sum()
    return reductions._combine(local, torch.sum, topo.group) \
        if len(topo) > 1 else local


def k1_grad_case(dims, which, *args):
    """The fault cases of repair 2 with K1 on its card path
    (:func:`card_k1`): K1 launches forward with and without grad and in
    the backward, by kind, and the gradient (padded global)."""
    topo = sub_topology(dims)
    if topo is None:
        return None
    with card_k1():
        return _rank0(_K1_CASES[which](topo, *args))


def _counted(fn):
    n0, kinds0 = k1.launches, _kinds()
    out = fn()
    return out, k1.launches - n0, _minus(_kinds(), kinds0)


def _k1_reshard(topo, shape, spec_a, spec_b, u):
    pa, pb = (_sub_pencil(topo, shape, *s) for s in (spec_a, spec_b))
    x = pat.PencilArray.from_global(pa, u)
    _, plain, _ = _counted(lambda: pat.reshard(x, pb, method=pat.AllToAll()))
    leaf = _leaf(x)
    v, fwd, _ = _counted(lambda: pat.reshard(pat.PencilArray(pa, leaf), pb,
                                             method=pat.AllToAll()))
    loss = pat.ops.sum(v * v)
    _, bwd, kinds = _counted(loss.backward)
    return dict(plain=plain, fwd=fwd, bwd=bwd, bwd_kinds=kinds,
                grad=to_numpy_padded(pat.PencilArray(pa, leaf.grad)))


def _k1_fft(topo, shape, kwargs, padded, extra):
    plan = pat.PencilFFTPlan(topo, shape, **kwargs)
    pen = plan.input_pencil
    leaf = from_numpy_padded(pen, padded, extra).data.requires_grad_()
    vjp_launches = []
    fft_mod = pat.ops.fft
    stage_vjp = fft_mod._stage_vjp

    def counted_vjp(*a, **kw):
        vjp = stage_vjp(*a, **kw)

        def run(g):
            n0 = k1.launches
            out = vjp(g)
            vjp_launches.append(k1.launches - n0)
            return out
        return run

    fft_mod._stage_vjp = counted_vjp
    try:
        uh, fwd, _ = _counted(lambda: plan.forward(
            pat.PencilArray(pen, leaf, extra)))
        loss = _all_sum(uh.data.abs() ** 2, topo)
        _, bwd, kinds = _counted(loss.backward)
    finally:
        fft_mod._stage_vjp = stage_vjp
    return dict(fwd=fwd, bwd=bwd, bwd_kinds=kinds,
                fused_vjp_launches=vjp_launches,
                grad=to_numpy_padded(pat.PencilArray(pen, leaf.grad, extra)))


def _k1_ns(topo, n, nu, dt, uh0_padded):
    model = _ns(topo, n, nu)
    pen = model.plan.output_pencil
    leaf = from_numpy_padded(pen, uh0_padded, (3,)).data.requires_grad_()
    out, fwd, _ = _counted(lambda: model.step(
        pat.PencilArray(pen, leaf, (3,)), dt))
    loss = _all_sum(out.data.abs() ** 2, topo)
    _, bwd, kinds = _counted(loss.backward)
    return dict(fwd=fwd, bwd=bwd, bwd_kinds=kinds,
                grad=to_numpy_padded(pat.PencilArray(pen, leaf.grad, (3,))))


_K1_CASES = {"reshard": _k1_reshard, "fft": _k1_fft, "ns": _k1_ns}
