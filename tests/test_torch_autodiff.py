"""PyTorch port vs JAX package: gradients through the whole stack.

Every case of ``tests/test_autodiff.py`` on a ``(2, 4)`` topology (the
port on 8 ranks of the shared gloo pool, the JAX package on its 8-device
CPU mesh, the same seeded inputs), at that file's own tolerances:
``test_grad_through_transpose`` under ``AllToAll``, ``Ring`` and
``Gspmd``; ``jax.jvp`` maps to a double backward (the JVP of a linear
map as the derivative of its vector-Jacobian product in the cotangent),
``jax.checkpoint`` to ``torch.utils.checkpoint``, and a ``PencilArray``
as the argument of ``jax.grad`` to a gradient taken through ``x.data``
and returned on ``x.pencil``.  Data movement's gradients are compared
with JAX's bit for bit; arithmetic within 1e-10 of the largest JAX
gradient (float64).  PyTorch's gradient of a real loss in a complex input
is the conjugate of JAX's.

The ``k1`` cases put kernel K1 on its card path while CPU tensors run it
(``torch_autodiff_tasks.card_k1``: ``permute.emulate`` stands in for the
launch and counts it) and show a K1 launch in the backward of a folded
reshard stage, of an FFT stage with extra dims, of the fused hop's
vector-Jacobian product and of one Navier-Stokes step, each gradient
equal to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pencilarrays_tpu as jpa
import torch_autodiff_tasks as tasks
import torch_rank_tasks
from pencilarrays_tpu import ops as jops

DIMS = (2, 4)
SHAPE = (12, 10, 8)
PERM = (2, 0, 1)
SPEC = ((1, 2), PERM)
SPEC_Y = ((0, 2), PERM)
SPEC_B = ((0, 1), (1, 2, 0))
ARITH = 1e-10        # arithmetic: relative to the largest JAX value


@pytest.fixture(scope="module")
def pool():
    return torch_rank_tasks.shared_pool()


def _topo(devices, dims=DIMS):
    import math

    return jpa.Topology(dims, devices=devices[:math.prod(dims)])


def _pen(topo, spec, shape=SHAPE):
    decomp, perm = spec
    return jpa.Pencil(topo, shape, decomp,
                      permutation=jpa.Permutation(*perm) if perm else None)


def _u(seed, shape=SHAPE):
    return np.random.default_rng(seed).standard_normal(shape)


def _run(pool, fn, *args):
    return pool.run(fn, *args)[0]


def _close(got, want, tol=ARITH):
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * scale, \
        np.abs(got - want).max() / scale


def _jax_grad_sum_sq(pen, x, move):
    def loss(d):
        v = move(jpa.PencilArray(pen, d))
        return jops.sum(v * v)

    return np.asarray(jax.jit(jax.grad(loss))(x.data))


@pytest.mark.parametrize("method", ["AllToAll", "Ring", "Gspmd"])
def test_grad_through_transpose(devices, pool, method):
    """d/du sum((T u)^2) = 2u through the hop and its inverse."""
    topo = _topo(devices)
    pen, pen_y = _pen(topo, SPEC), _pen(topo, SPEC_Y)
    u = _u(0)
    x = jpa.PencilArray.from_global(pen, u)
    m = getattr(jpa, method)()
    g = _jax_grad_sum_sq(pen, x, lambda v: jpa.transpose(v, pen_y, method=m))
    want = jpa.gather(jpa.PencilArray(pen, g))
    np.testing.assert_allclose(want, 2 * u, rtol=1e-12)
    got, padded = _run(pool, tasks.grad_transpose_case, DIMS, SHAPE, SPEC,
                       SPEC_Y, u, method)
    assert np.array_equal(got, want) and np.array_equal(padded, g)


def test_grad_through_reshard(devices, pool):
    topo = _topo(devices)
    pen, pen_b = _pen(topo, SPEC), _pen(topo, SPEC_B)
    u = _u(0)
    x = jpa.PencilArray.from_global(pen, u)
    g = _jax_grad_sum_sq(pen, x, lambda v: jpa.reshard(v, pen_b))
    want = jpa.gather(jpa.PencilArray(pen, g))
    np.testing.assert_allclose(want, 2 * u, rtol=1e-12)
    got, padded = _run(pool, tasks.grad_transpose_case, DIMS, SHAPE, SPEC,
                       SPEC_B, u, "reshard")
    assert np.array_equal(got, want) and np.array_equal(padded, g)


def test_transpose_is_linear_jvp(devices, pool):
    """The JVP of a transpose is the transpose of the tangent, bit for
    bit (JAX: ``jax.jvp``; the port: a double backward)."""
    topo = _topo(devices)
    pen, pen_y = _pen(topo, SPEC), _pen(topo, SPEC_Y)
    u, t = _u(0), np.random.default_rng(1).standard_normal(SHAPE)
    x = jpa.PencilArray.from_global(pen, u)
    tx = jpa.PencilArray.from_global(pen, t)

    def f(d):
        return jpa.transpose(jpa.PencilArray(pen, d), pen_y).data

    _, dy = jax.jvp(f, (x.data,), (tx.data,))
    dy_port, t_moved = _run(pool, tasks.jvp_transpose_case, DIMS, SHAPE,
                            SPEC, SPEC_Y, u, t)
    assert np.array_equal(dy_port, t_moved)
    assert np.array_equal(dy_port, np.asarray(dy))


def _jax_fft_power_grad(plan, x, remat=False):
    def body(d):
        uh = plan.forward(jpa.PencilArray(plan.input_pencil, d))
        return jops.sum(jpa.PencilArray(uh.pencil, jnp.abs(uh.data) ** 2,
                                        uh.extra_dims))

    f = jax.checkpoint(body) if remat else body
    g = jax.jit(jax.grad(f))(x.data)
    return jpa.gather(jpa.PencilArray(plan.input_pencil, g))


def test_grad_through_fft_plan_fd(devices, pool):
    """d/du sum|F u|^2 through a distributed r2c plan: finite differences
    at three points (rtol 1e-4) and JAX's gradient."""
    topo = _topo(devices)
    plan = jpa.PencilFFTPlan(topo, SHAPE, real=True, dtype=np.float64)
    u = _u(2)
    want = _jax_fft_power_grad(
        plan, jpa.PencilArray.from_global(plan.input_pencil, u))
    (g,) = _run(pool, tasks.grad_fft_case, DIMS, SHAPE, u)
    _close(g, want)

    def np_loss(uu):
        return np.sum(np.abs(np.fft.fftn(np.fft.rfft(uu, axis=0),
                                         axes=(1, 2))) ** 2)

    eps = 1e-6
    for (i, j, k) in [(0, 0, 0), (3, 4, 5), (11, 9, 7)]:
        up, un = u.copy(), u.copy()
        up[i, j, k] += eps
        un[i, j, k] -= eps
        fd = (np_loss(up) - np_loss(un)) / (2 * eps)
        np.testing.assert_allclose(g[i, j, k], fd, rtol=1e-4)


def test_fft_roundtrip_grad_identity(devices, pool):
    """The gradient of sum(backward(forward(u)) * w) is w."""
    topo = _topo(devices)
    plan = jpa.PencilFFTPlan(topo, SHAPE, real=True, dtype=np.float64)
    u, w = _u(3), _u(4)
    wx = jpa.PencilArray.from_global(plan.input_pencil, w)

    def loss(d):
        rt = plan.backward(plan.forward(jpa.PencilArray(plan.input_pencil,
                                                        d)))
        return jops.sum(rt * wx)

    x = jpa.PencilArray.from_global(plan.input_pencil, u)
    want = jpa.gather(jpa.PencilArray(plan.input_pencil,
                                      jax.jit(jax.grad(loss))(x.data)))
    (g,) = _run(pool, tasks.grad_fft_case, DIMS, SHAPE, u, w)
    np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-10)
    _close(g, want)


def test_pencilarray_is_grad_argument(devices, pool):
    """The gradient of ``norm`` comes back on the input's pencil."""
    topo = _topo(devices)
    pen = _pen(topo, SPEC)
    u = _u(5)
    g = jax.grad(jops.norm)(jpa.PencilArray.from_global(pen, u))
    same_pencil, got = _run(pool, tasks.grad_norm_case, DIMS, SHAPE, SPEC, u)
    assert same_pencil
    np.testing.assert_allclose(got, u / np.linalg.norm(u), rtol=1e-10)
    _close(got, jpa.gather(g))


def test_grad_through_arithmetic_and_stack(devices, pool):
    """``PencilArray`` arithmetic and ``PencilArray.stack`` under grad,
    through a transpose of the 3-component stack (one script for both
    packages, ``torch_autodiff_tasks.arith_stack``)."""
    topo = _topo(devices)
    pen, pen_y = _pen(topo, SPEC), _pen(topo, SPEC_Y)
    u = _u(13)
    x = jpa.PencilArray.from_global(pen, u)
    want = np.asarray(jax.jit(jax.grad(lambda d: tasks.arith_stack(
        jpa, jpa.PencilArray(pen, d), pen_y)))(x.data))
    got = _run(pool, tasks.grad_arith_stack_case, DIMS, SHAPE, SPEC, SPEC_Y,
               u)
    _close(got, want, 1e-12)


@pytest.fixture(scope="module")
def ns_ref(devices):
    """The JAX package's one RK2 step at 8^3 f64 on (2, 4): the initial
    state, a unit direction, the gradient of sum|step(uh).data|^2 and the
    central difference along the direction."""
    from pencilarrays_tpu.models import NavierStokesSpectral, taylor_green

    model = NavierStokesSpectral(_topo(devices), 8, viscosity=0.05,
                                 dtype=jnp.float64)
    uh0 = taylor_green(model)
    d = np.random.default_rng(6).standard_normal(uh0.data.shape)
    d = d / np.linalg.norm(d)

    def loss(data):
        out = model.step(jpa.PencilArray(uh0.pencil, data, uh0.extra_dims),
                         NS_DT)
        return jnp.sum(jnp.abs(out.data) ** 2)

    g = np.asarray(jax.jit(jax.grad(loss))(uh0.data))
    return np.asarray(uh0.data), d, g


NS_N, NS_NU, NS_DT, NS_EPS = 8, 0.05, 1e-2, 1e-5


def test_grad_through_ns_step(pool, ns_ref):
    """One Navier-Stokes RK2 step end to end: the directional derivative
    against a central difference (rtol 1e-4, JAX's bar), the gradient
    against JAX's, and the same gradient under
    ``torch.utils.checkpoint``."""
    uh0, d, g_jax = ns_ref
    r = _run(pool, tasks.grad_ns_case, DIMS, NS_N, NS_NU, NS_DT, uh0, d,
             NS_EPS, True)
    fd = (r["lp"] - r["lm"]) / (2 * NS_EPS)
    dd = float(np.sum(np.real(r["grad"] * d)))
    np.testing.assert_allclose(dd, fd, rtol=1e-4)
    _close(np.conj(r["grad"]), g_jax)
    np.testing.assert_allclose(r["remat"], r["grad"], rtol=1e-12)


def test_remat_through_plan(devices, pool):
    """torch.utils.checkpoint through the plan: the same gradient."""
    topo = _topo(devices)
    plan = jpa.PencilFFTPlan(topo, SHAPE, real=True, dtype=np.float64)
    u = _u(7)
    x = jpa.PencilArray.from_global(plan.input_pencil, u)
    want = _jax_fft_power_grad(plan, x, remat=True)
    g_plain, g_remat = _run(pool, tasks.grad_fft_case, DIMS, SHAPE, u,
                            None, True)
    np.testing.assert_allclose(g_plain, g_remat, rtol=1e-12)
    _close(g_remat, want)


def test_grad_through_masked_reductions(devices, pool):
    """Masked reductions: the gradient is zero on tail padding and
    exact on true data (a ragged shape forces real padding): sum, mean,
    norm, dot, and (across ranks, the combining collective's own
    gradient) maximum and prod, against JAX's padded gradients."""
    shape = (9, 7, 5)
    spec = ((1, 2), None)
    pen = _pen(_topo(devices), spec, shape)
    u, v = _u(8, shape), _u(9, shape)
    x = jpa.PencilArray.from_global(pen, u)
    vx = jpa.PencilArray.from_global(pen, v)
    true = np.asarray(jpa.PencilArray.from_global(
        pen, np.ones(shape)).data) == 1
    assert not true.all()
    want = {name: np.asarray(jax.grad(f)(x).data) for name, f in (
        ("sum", lambda a: jops.sum(a * a)), ("mean", jops.mean),
        ("norm", jops.norm), ("dot", lambda a: jops.dot(a, vx)),
        ("maximum", jops.maximum),
        ("prod", lambda a: jops.prod(a * 0.1 + 1.0)))}
    got = _run(pool, tasks.grad_reductions_case, DIMS, shape, spec, u, v)
    assert np.array_equal(got["sum"], want["sum"])
    np.testing.assert_allclose(got["mean"][true], 1.0 / u.size, rtol=1e-12)
    for name in want:
        assert (got[name][~true] == 0).all(), name
        _close(got[name], want[name], 1e-12)


def test_grad_of_tied_extrema_across_ranks(devices, pool):
    """maximum, minimum and norm(inf) with the extremum tied at three
    elements, two on one rank and one on another (and |.| tied at +-m):
    each tied element takes a third of the gradient, as ``jnp.max``
    splits it, on the ranks that hold them."""
    shape = (9, 7, 5)
    spec = ((1, 2), None)
    pen = _pen(_topo(devices), spec, shape)
    u = _u(11, shape)
    m = np.abs(u).max() + 1.0
    u[0, 0, 0] = u[1, 0, 0] = u[-1, -1, -1] = m
    u[0, 0, 1] = u[1, 0, 1] = -m
    u[-1, -1, -2] = -m
    # (0, 0, *) and (1, 0, *) share the rank at coordinates (0, 0) of
    # dims 1 and 2; (-1, -1, *) lies on the rank at (1, 3)
    x = jpa.PencilArray.from_global(pen, u)
    want = {name: np.asarray(jax.grad(f)(x).data) for name, f in (
        ("maximum", jops.maximum), ("minimum", jops.minimum),
        ("norm_inf", lambda a: jops.norm(a, np.inf)))}
    got = _run(pool, tasks.grad_extrema_case, DIMS, shape, spec, u)
    for name in want:
        assert np.count_nonzero(want[name]) in (3, 6), name
        _close(got[name], want[name], 1e-12)


# -- kernel K1 on the gradient paths (the card's launches, emulated) --------

def _padded_jax_grad(plan, u, extra=()):
    """JAX's gradient of sum|forward(u).data|^2 (padded, raw sum)."""
    x = jpa.PencilArray.from_global(plan.input_pencil, u)

    def loss(d):
        uh = plan.forward(jpa.PencilArray(plan.input_pencil, d, extra))
        return jnp.sum(jnp.abs(uh.data) ** 2)

    return np.asarray(x.data), np.asarray(jax.jit(jax.grad(loss))(x.data))


def test_k1_backward_through_folded_reshard_stage(devices, pool):
    """On (2, 1) the route's hops over the size-1 axis fold into one K1
    permute, with grad as without it (the same forward launches), and
    the backward launches K1's inverse permute: the gradient is JAX's
    2u, bit for bit."""
    dims = (2, 1)
    topo = _topo(devices, dims)
    pen, pen_b = _pen(topo, SPEC), _pen(topo, SPEC_B)
    u = _u(10)
    x = jpa.PencilArray.from_global(pen, u)
    want = _jax_grad_sum_sq(pen, x, lambda v: jpa.reshard(
        v, pen_b, method=jpa.AllToAll()))
    r = _run(pool, tasks.k1_grad_case, dims, "reshard", SHAPE, SPEC, SPEC_B,
             u)
    assert r["fwd"] == r["plain"] > 0
    assert r["bwd_kinds"].get("permute", 0) >= 1, r["bwd_kinds"]
    assert np.array_equal(r["grad"], want)


def test_k1_backward_through_fft_stage_with_extra_dims(devices, pool):
    """An r2c plan on a 3-component field: each stage moves the
    components around the transform with K1, and the backward launches
    K1 for those moves; the gradient is JAX's."""
    dims = (2, 2)
    plan = jpa.PencilFFTPlan(_topo(devices, dims), SHAPE, real=True,
                             dtype=np.float64)
    u = _u(11, SHAPE + (3,))
    padded, want = _padded_jax_grad(plan, u, (3,))
    r = _run(pool, tasks.k1_grad_case, dims, "fft", SHAPE,
             dict(real=True, dtype="float64"), padded, (3,))
    assert r["bwd_kinds"].get("permute", 0) >= 2 * 3, r["bwd_kinds"]
    _close(r["grad"], want)


def test_k1_backward_through_fused_hop_vjp(devices, pool):
    """A pipelined plan (fused hops) on a 3-component field: the fused
    hop's vector-Jacobian product moves the components with K1 (each of
    its stage VJPs launches K1); the gradient is JAX's."""
    dims, shape = (2, 2), (16, 12, 10)
    plan = jpa.PencilFFTPlan(_topo(devices, dims), shape, real=True,
                             dtype=np.float64, pipeline=2)
    u = _u(12, shape + (3,))
    padded, want = _padded_jax_grad(plan, u, (3,))
    r = _run(pool, tasks.k1_grad_case, dims, "fft", shape,
             dict(real=True, dtype="float64", pipeline=2), padded, (3,))
    assert r["fused_vjp_launches"], "no fused hop in the backward"
    assert all(n > 0 for n in r["fused_vjp_launches"]), \
        r["fused_vjp_launches"]
    _close(r["grad"], want)


def test_k1_backward_through_ns_step(pool, ns_ref):
    """One Navier-Stokes RK2 step: K1 moves the 3- and 6-component
    stacks around each transform forward and backward; the gradient is
    JAX's."""
    uh0, _, g_jax = ns_ref
    r = _run(pool, tasks.k1_grad_case, DIMS, "ns", NS_N, NS_NU, NS_DT, uh0)
    assert r["bwd_kinds"].get("permute", 0) > 0, r["bwd_kinds"]
    assert r["bwd"] > 0
    _close(np.conj(r["grad"]), g_jax)


def test_k1_autograd_function_and_its_refusals():
    """On K1's card path (emulated): ``permute`` of an input that
    requires grad is differentiable, its backward one K1 launch of the
    inverse permute; with ``out=`` it raises, and so do ``pack`` and
    ``unpack`` (their gradient is the hop's); under ``torch.no_grad()``
    all three launch as before."""
    import torch

    from pencilarrays_tpu_torch.ops import permute as k1

    x = torch.randn(4, 5, 6, dtype=torch.float64, requires_grad=True)
    g = torch.randn(6, 4, 5, dtype=torch.float64)
    with tasks.card_k1():
        y = k1.permute(x, (2, 0, 1))
        assert y.grad_fn is not None
        n0 = k1.launches
        y.backward(g)
        assert k1.launches == n0 + 1
        assert torch.equal(x.grad, g.permute(1, 2, 0))
        with pytest.raises(RuntimeError, match="out= has no gradient"):
            k1.permute(x, (2, 0, 1), out=torch.empty(6, 4, 5,
                                                     dtype=torch.float64))
        with pytest.raises(RuntimeError, match="no gradient of its own"):
            k1.pack(x, (0, 1, 2), 0, 2)
        t = torch.randn(2, 2, 5, 6, dtype=torch.float64, requires_grad=True)
        with pytest.raises(RuntimeError, match="no gradient of its own"):
            k1.unpack(t, (0, 1, 2), 0, 4)
        with torch.no_grad():
            assert torch.equal(k1.pack(x, (0, 1, 2), 0, 2),
                               k1.pack_plain(x.detach(), (0, 1, 2), 0, 2))
