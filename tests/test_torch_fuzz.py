"""PyTorch port vs JAX package: the seeded randomized sweeps.

``tests/test_fuzz.py``'s seeds draw the same configurations here (its own
``_draw_config``, ``_rand_global`` and ``_draw_kinds``, in its order of
draws): shapes with prime and barely-ragged extents, topologies
``(8,)``, ``(2, 4)``, ``(4, 2)`` and ``(2, 2, 2)``, permutations, extra
dims, dtypes, methods (``AllToAll``, ``Ring``, ``Gspmd``, ``Auto()``,
``Auto(latency_bytes=0)``) and multi-hop chains.  The port runs on 8 ranks
of the shared gloo pool, the JAX package on its 8-device CPU mesh.  Every
hop's padded array is JAX's bit for bit and gathers to the input; the
walk back is bit-identical to the start; reductions agree with numpy
within 1e-10 (float64; min, max and counts exactly) and with JAX's; FFT
plans within 1e-8 of scipy/numpy (the JAX file's bar) and of JAX's.  As
in the JAX file, the FFT sweep runs seed 0 by default and seeds 1-9 under
``slow``.  Flash attention's fuzz holds the port's kernel path (on the
CPU, the kernels' plain versions) against the port's dense attention and
its plain path, forward within 1e-5 and gradients within 2e-5.
"""

import numpy as np
import pytest
import torch

import pencilarrays_tpu as jpa
import torch_parity_tasks as tasks
import torch_rank_tasks
from pencilarrays_tpu.ops import reductions as jred
from test_fuzz import (EXTENTS, METHODS, TOPOS, _draw_config, _draw_kinds,
                       _numpy_reference, _rand_global)

# METHODS of the JAX file, by index, as the port's method specs
PORT_METHODS = [("AllToAll", {}), ("Ring", {}), ("Gspmd", {}), ("Auto", {}),
                ("Auto", {"latency_bytes": 0})]


@pytest.fixture(scope="module")
def pool():
    return torch_rank_tasks.shared_pool()


def _spec(pen):
    perm = None if pen.permutation.is_identity() else tuple(
        pen.permutation.apply(tuple(range(pen.ndims))))
    return tuple(pen.decomposition), perm


def _pencil(topo, shape, decomp, perm):
    return jpa.Pencil(topo, shape, decomp, permutation=perm)


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_transpose_chain(devices, pool, seed):
    """Random multi-hop chains: every hop JAX's bits, the return path
    bit-identical to the start."""
    assert len(METHODS) == len(PORT_METHODS)
    rng = np.random.default_rng(1000 + seed)
    tdims, shape, decomp, perm, extra, dtype = _draw_config(rng)
    topo = jpa.Topology(tdims, devices=devices)
    N, M = len(shape), len(tdims)
    pen = _pencil(topo, shape, decomp, perm)
    u = _rand_global(rng, shape, extra, dtype)
    arr = jpa.PencilArray.from_global(pen, u)
    pens, methods, want = [pen], [], []
    cur = pen
    for _ in range(int(rng.integers(1, 4))):
        dec = list(cur.decomposition)
        slot = int(rng.integers(M))
        free = [d for d in range(N) if d not in dec]
        if free and rng.random() < 0.8:
            dec[slot] = free[rng.integers(len(free))]
        nperm = (None if rng.random() < 0.4
                 else jpa.Permutation(tuple(rng.permutation(N).tolist())))
        nxt = _pencil(topo, shape, tuple(dec), nperm)
        k = int(rng.integers(len(METHODS)))
        arr = jpa.transpose(arr, nxt, method=METHODS[k])
        want.append(np.asarray(arr.data))
        pens.append(nxt)
        methods.append(PORT_METHODS[k])
        cur = nxt
    r = pool.run(tasks.chain_case, tdims, shape, [_spec(p) for p in pens],
                 u, methods)[0]
    for (bits, got), w in zip(r["hops"], want):
        assert np.array_equal(bits, w)
        assert np.array_equal(got, u)
    assert r["same"] and np.array_equal(r["back"], u)


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_reshard(devices, pool, seed):
    """reshard between two random pencils (any number of slots at once):
    JAX's bits."""
    rng = np.random.default_rng(2000 + seed)
    tdims, shape, decomp, perm, extra, dtype = _draw_config(rng)
    topo = jpa.Topology(tdims, devices=devices)
    N, M = len(shape), len(tdims)
    pen_a = _pencil(topo, shape, decomp, perm)
    dec_b = tuple(sorted(rng.choice(N, size=M, replace=False).tolist()))
    perm_b = (None if rng.random() < 0.4
              else jpa.Permutation(tuple(rng.permutation(N).tolist())))
    pen_b = _pencil(topo, shape, dec_b, perm_b)
    u = _rand_global(rng, shape, extra, dtype)
    want = np.asarray(jpa.reshard(jpa.PencilArray.from_global(pen_a, u),
                                  pen_b).data)
    r = pool.run(tasks.chain_case, tdims, shape, [_spec(pen_a),
                                                  _spec(pen_b)],
                 u, ["reshard"], False, False)[0]
    (bits, got), = r["hops"]
    assert np.array_equal(got, u) and np.array_equal(bits, want)


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_reductions(devices, pool, seed):
    """Masked reductions on random ragged configurations: numpy's and
    JAX's values."""
    rng = np.random.default_rng(3000 + seed)
    tdims, shape, decomp, perm, extra, _ = _draw_config(rng)
    topo = jpa.Topology(tdims, devices=devices)
    pen = _pencil(topo, shape, decomp, perm)
    u = _rand_global(rng, shape, extra, np.float64)
    x = jpa.PencilArray.from_global(pen, u)
    names = ["sum", "mean", "minimum", "maximum", "norm", "count_nonzero"]
    r = pool.run(tasks.reductions_case, tdims, shape, _spec(pen), u, names,
                 extra)[0]
    for name in ("sum", "mean", "norm"):
        np.testing.assert_allclose(r[name], float(getattr(jred, name)(x)),
                                   rtol=1e-12)
    np.testing.assert_allclose(r["sum"], u.sum(), rtol=1e-10)
    np.testing.assert_allclose(r["mean"], u.mean(), rtol=1e-10)
    np.testing.assert_allclose(r["norm"], np.linalg.norm(u.ravel()),
                               rtol=1e-10)
    assert r["minimum"] == u.min() and r["maximum"] == u.max()
    assert r["count_nonzero"] == np.count_nonzero(u)


@pytest.mark.parametrize(
    "seed",
    [0] + [pytest.param(s, marks=pytest.mark.slow) for s in range(1, 10)])
def test_fuzz_fft_plans(devices, pool, seed):
    """Random per-dim transform tuples on random topologies and shapes:
    scipy/numpy's and JAX's spectra, and the inverse."""
    pytest.importorskip("scipy")
    rng = np.random.default_rng(4000 + seed)
    tdims = TOPOS[rng.integers(len(TOPOS))]
    M = len(tdims)
    N = int(rng.integers(M + 1, 5))
    shape = tuple(int(EXTENTS[rng.integers(len(EXTENTS))])
                  for _ in range(N))
    kinds = _draw_kinds(rng, N)
    plan = jpa.PencilFFTPlan(jpa.Topology(tdims, devices=devices), shape,
                             transforms=kinds, dtype=np.float64)
    u = rng.standard_normal(shape)
    want = jpa.gather(plan.forward(
        jpa.PencilArray.from_global(plan.input_pencil, u)))
    got, back = pool.run(tasks.fft_case, tdims, shape, u,
                         dict(transforms=kinds, dtype="float64"))[0]
    np.testing.assert_allclose(got, _numpy_reference(u, kinds), rtol=1e-8,
                               atol=1e-8)
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(back, u, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_flash_vs_dense(seed):
    """The JAX file's draws of shapes, offsets and causality: the port's
    kernel path against its dense attention, forward and gradients (the
    kernel path's backward against the plain path's)."""
    from pencilarrays_tpu_torch.models.attention import (
        dense_attention, flash_attention)

    rng = np.random.default_rng(1000 + seed)
    sq = int(rng.integers(8, 140))
    skv = int(rng.integers(8, 200))
    h = int(rng.integers(1, 3))
    d = int(rng.choice([8, 16, 32]))
    causal = bool(rng.random() < 0.5)
    q_off = int(rng.integers(0, 12)) if causal else 0
    kv_off = int(rng.integers(0, 8)) if causal else 0

    def t(shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32)

    q, k, v = t((sq, h, d)), t((skv, h, d)), t((skv, h, d))
    rows_ok = np.ones(sq, bool) if not causal else (
        (q_off + np.arange(sq)) >= kv_off)
    ct = torch.tensor(rng.standard_normal((sq, h, d))
                      * rows_ok[:, None, None], dtype=torch.float32)
    ref = dense_attention(q, k, v, causal=causal, q_offset=q_off,
                          kv_offset=kv_off)
    got = flash_attention(q, k, v, causal=causal, impl="kernel",
                          q_offset=q_off, kv_offset=kv_off)
    np.testing.assert_allclose(got.numpy()[rows_ok], ref.numpy()[rows_ok],
                               atol=1e-5, rtol=1e-5)

    def grads(impl):
        leaves = [a.clone().requires_grad_() for a in (q, k, v)]
        (flash_attention(*leaves, causal=causal, impl=impl, q_offset=q_off,
                         kv_offset=kv_off) * ct).sum().backward()
        return [a.grad for a in leaves]

    for a, b in zip(grads("kernel"), grads("plain")):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5,
                                   rtol=2e-5)
