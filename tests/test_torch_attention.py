"""PyTorch port vs JAX package: sequence-parallel attention on gloo ranks.

The same global q/k/v and cotangent (NumPy, from a seed) go through the
JAX package on a ``Topology((P,))`` of the 8-device CPU mesh (its
``impl="xla"`` path, differentiated by ``jax.grad``) and through the port
on ``P`` gloo ranks (one process each; ``P = 1`` in this process), whose
kernel path runs the plain versions of K2–K4 on the CPU.  Outputs agree
to 1e-5 and q/k/v gradients to 2e-5 in float32, 3e-2 / 6e-2 in bfloat16
(the tolerances of the JAX package's attention tests); the zigzag layout
helpers are pure data movement and agree bit for bit.  Gradients through
a pencil hop are the inverse hop of the cotangent, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pencilarrays_tpu as jpa
import torch_rank_tasks as tasks
from pencilarrays_tpu.models import attention as jatt
from pencilarrays_tpu_torch.parallel.distributed import RankPool

TOL = {False: (1e-5, 2e-5), True: (3e-2, 6e-2)}   # (fwd, grads) by bf16


class _Pools:
    """One live pool at a time; tests are ordered by rank count, so the
    pool is rebuilt only when the count changes.  P = 1 runs here."""

    def __init__(self):
        self.n, self.pool = None, None

    def run(self, n, fn, *args):
        if n == 1:
            return fn(*args)
        if self.n != n:
            self.close()
            self.pool, self.n = RankPool(n), n
        return self.pool.run(fn, *args)[0]

    def close(self):
        if self.pool is not None:
            self.pool.close()
        self.n, self.pool = None, None


@pytest.fixture(scope="module")
def pools():
    p = _Pools()
    yield p
    p.close()


def _inputs(S, H, extra, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((S, H) + extra).astype(np.float32)
            for _ in range(4)]


def _jax_case(devices, P, scheme, causal, q, k, v, ct, bf16):
    """The JAX package's output and q/k/v grads of sum(out * ct)."""
    topo = jpa.Topology((P,), devices=devices[:P])
    pen = jpa.Pencil(topo, q.shape[:2], (0,))
    extra = q.shape[2:]
    dt = jnp.bfloat16 if bf16 else jnp.float32
    arrs = [jpa.PencilArray.from_global(pen, x).astype(dt) for x in (q, k, v)]
    if scheme == "zigzag":
        arrs = [jatt.to_zigzag(x) for x in arrs]

    def fwd(qd, kd, vd):
        qkv = [jpa.PencilArray(pen, d, extra) for d in (qd, kd, vd)]
        if scheme == "ulysses":
            return jatt.ulysses_attention(*qkv, causal=causal, impl="xla")
        return jatt.ring_attention(*qkv, causal=causal,
                                   zigzag=scheme == "zigzag", impl="xla")

    def loss(qd, kd, vd):
        out = fwd(qd, kd, vd).data.astype(jnp.float32)
        return jnp.sum(out * ct), out

    # one jitted program: eager shard_map would compile op by op
    step = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))
    with jax.default_matmul_precision("float32"):
        (_, out), grads = step(*(x.data for x in arrs))
    as32 = [np.asarray(jnp.asarray(g, jnp.float32)) for g in grads]
    return np.asarray(out), as32, arrs


# (P, scheme, causal, S, H, extra, bf16), ordered by rank count
CASES = [
    (1, "ulysses", False, 32, 4, (16,), False),
    (1, "ring", True, 32, 4, (16,), False),
    (1, "ulysses", True, 24, 3, (2, 8), True),
    (2, "ulysses", False, 32, 4, (16,), False),
    (2, "ulysses", True, 32, 3, (16,), False),      # ragged H
    (2, "ring", True, 32, 2, (16,), False),
    (2, "ring", False, 32, 2, (3, 8), False),       # batch dims
    (2, "zigzag", True, 32, 2, (16,), False),
    (2, "ring", True, 32, 2, (16,), True),
    (4, "ulysses", True, 32, 8, (16,), False),
    (4, "ulysses", False, 32, 3, (2, 8), False),    # ragged H, batch dims
    (4, "ring", True, 32, 2, (16,), False),
    (4, "ring", False, 32, 2, (16,), False),
    (4, "zigzag", True, 64, 2, (16,), False),
    (4, "ulysses", True, 32, 4, (16,), True),
    (3, "zigzag", True, 48, 2, (16,), False),       # odd P
    (3, "zigzag", True, 48, 2, (2, 8), True),
]


def _case_id(case):
    P, scheme, causal, S, H, extra, bf16 = case
    return (f"P{P}-{scheme}-{'causal' if causal else 'full'}-S{S}-H{H}-"
            f"{'x'.join(map(str, extra))}-{'bf16' if bf16 else 'f32'}")


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_attention_matches_jax(devices, pools, case):
    P, scheme, causal, S, H, extra, bf16 = case
    q, k, v, ct = _inputs(S, H, extra, seed=S + H + P)
    want_out, want_grads, jarrs = _jax_case(devices, P, scheme, causal, q, k,
                                            v, ct, bf16)
    got = pools.run(P, tasks.attention_case, P, scheme, causal, "auto", q, k,
                    v, ct, bf16)
    tol_fwd, tol_grad = TOL[bf16]
    np.testing.assert_allclose(got["out"], want_out, atol=tol_fwd,
                               rtol=tol_fwd)
    for g, w in zip(got["grads"], want_grads):
        np.testing.assert_allclose(g, w, atol=tol_grad, rtol=tol_grad)
    if scheme == "zigzag":
        for a, ja in zip(got["zigzag_in"], jarrs):
            want = np.asarray(jnp.asarray(jpa.gather(ja), jnp.float32))
            np.testing.assert_array_equal(a.view(np.uint32),
                                          want.view(np.uint32))
        for a, x in zip(got["round_trip"], (q, k, v)):
            want = x if not bf16 else np.asarray(
                jnp.asarray(jnp.asarray(x, jnp.bfloat16), jnp.float32))
            np.testing.assert_array_equal(a.view(np.uint32),
                                          want.view(np.uint32))


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_impls_agree_on_ranks(devices, pools, impl):
    """Both impls of the port's ring give JAX's result (forced, not auto)."""
    P, S, H, extra = 2, 32, 2, (16,)
    q, k, v, ct = _inputs(S, H, extra, seed=3)
    want_out, want_grads, _ = _jax_case(devices, P, "ring", True, q, k, v,
                                        ct, False)
    got = pools.run(P, tasks.attention_case, P, "ring", True, impl, q, k, v,
                    ct)
    np.testing.assert_allclose(got["out"], want_out, atol=1e-5, rtol=1e-5)
    for g, w in zip(got["grads"], want_grads):
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=2e-5)


# (P, zigzag, per-rank flash_attention_bwd_partials calls of one backward):
# the naive ring makes P calls, the zigzag one 3 + 2 (P - 1)
RING_COTANGENT = [(1, False, 1), (2, True, 5)]


@pytest.mark.parametrize("case", RING_COTANGENT,
                         ids=["P1-naive", "P2-zigzag"])
def test_ring_backward_cotangent_dtype(pools, case):
    """A bf16 ring backward hands K3/K4 the cotangent in bf16 (so on the
    card it takes their wgmma instance), and the grads are bit-identical
    to those computed when the same calls get it widened to f32: call by
    call and for the whole backward."""
    P, zigzag, n_calls = case
    q, k, v, ct = _inputs(32, 2, (16,), seed=21)
    got = pools.run(P, tasks.ring_cotangent_case, P, zigzag, q, k, v, ct)
    assert [c[0] for c in got["calls"]] == ["torch.bfloat16"] * 2 * n_calls
    assert all(c[1] for c in got["calls"])
    assert got["grad_dtypes"] == ["torch.bfloat16"] * 3
    assert got["same"]


X, Y = ((1, 2), None), ((0, 2), None)
HOPS = [
    ((2, 2), (9, 10, 11), (), [X, Y]),
    ((2, 2), (15, 14, 13), (3,), [((1, 2), (2, 0, 1)), ((0, 2), (1, 2, 0))]),
    ((2, 2), (6, 7, 5), (2,), [X, ((1, 2), (2, 1, 0))]),   # local permute
]


@pytest.mark.parametrize("case", HOPS, ids=["xy", "xy-perm-extra",
                                            "local-perm"])
def test_hop_gradient_matches_jax(devices, pools, case):
    """The backward of a hop (the inverse hop) gives jax.grad's gradient
    bit for bit, padding positions (zero) included."""
    dims, shape, extra, specs = case
    topo = jpa.Topology(dims, devices=devices[:4])
    pin, pout = (jpa.Pencil(topo, shape, d, permutation=None if p is None
                            else jpa.Permutation(*p)) for d, p in specs)
    rng = np.random.default_rng(5)
    x = jpa.PencilArray.from_global(
        pin, rng.standard_normal(shape + extra).astype(np.float32))
    ct = np.asarray(jpa.PencilArray.from_global(
        pout, rng.standard_normal(shape + extra).astype(np.float32)).data)

    def loss(data):
        y = jpa.transpose(jpa.PencilArray(pin, data, extra), pout)
        return jnp.sum(y.data * ct)

    want = np.asarray(jax.jit(jax.grad(loss))(x.data))
    got = pools.run(4, tasks.hop_grad_case, dims, shape, extra, specs,
                    np.asarray(x.data), ct)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_validation():
    """The JAX package's argument checks, on a 1-rank topology."""
    import pencilarrays_tpu_torch as pat
    from pencilarrays_tpu_torch.models import ring_attention, ulysses_attention

    pen = pat.Pencil(pat.Topology((1,), device="cpu"), (16, 2), (0,))
    u = pat.PencilArray.zeros(pen, (8,))
    with pytest.raises(ValueError):
        ring_attention(u, u, u, zigzag=True)           # zigzag needs causal
    with pytest.raises(ValueError):
        ring_attention(u, u, u, impl="pallas")         # the JAX name
    with pytest.raises(ValueError):
        ulysses_attention(u, u, pat.PencilArray.zeros(pen, (4,)))
    small = pat.PencilArray.zeros(pen, (4,))           # d = 4: no kernel
    with pytest.raises(ValueError):
        ring_attention(small, small, small, causal=True, impl="kernel")
    out = ring_attention(small, small, small, causal=True)   # auto: plain
    assert torch.isfinite(out.data).all()
