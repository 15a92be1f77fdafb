"""PyTorch port vs JAX package: flash attention K2–K4 and flash_attention.

The same inputs (NumPy, from a seed) go through the JAX package's Pallas
kernels in interpret mode (small shapes, ``block_q`` 32/64, as in
``tests/test_flash_pallas.py``) and through the plain versions of the
port's K2–K4, which are what the kernels' wrappers run for CPU tensors;
``flash_attention`` values and gradients are held against the JAX
package's ``impl="xla"`` path and ``jax.grad``.  Tolerances: float32 1e-5
forward, 2e-5 gradients; bfloat16 3e-2 / 6e-2.  Rows with no visible key
are unspecified (finite) in both packages and are not compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pencilarrays_tpu.models import attention as jatt
from pencilarrays_tpu.ops import flash_pallas as jfp
from pencilarrays_tpu_torch.models import attention as att
from pencilarrays_tpu_torch.ops import flash

F32 = jax.default_matmul_precision("float32")


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _torch(a, bf16=False):
    t = torch.from_numpy(np.array(a, np.float32))   # a writable copy
    return t.to(torch.bfloat16) if bf16 else t


def _np(t):
    return t.detach().float().numpy()


def _jax(a, bf16=False):
    return jnp.asarray(a, jnp.bfloat16 if bf16 else jnp.float32)


@pytest.mark.parametrize("d", [8, 60, 64, 1024, 1032])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64",
                                   "float16"])
def test_supported_matches_jax(d, dtype):
    """The JAX package's dtype and head-dim rules (its CPU platform)."""
    want = jfp.supported(256, 256, d, jnp.dtype(dtype), platform="cpu")
    assert flash.supported(d, getattr(torch, dtype)) == want
    # operands are read each in its own dtype: a mix is taken when every
    # one of them is
    mixed = flash.supported(d, torch.bfloat16, getattr(torch, dtype),
                            torch.float32)
    assert mixed == want


# (sq, skv, h, b, d, causal, q_offset, kv_offset, block_q, bf16)
FWD = [
    (80, 140, 2, 1, 16, False, 0, 0, 64, False),   # ragged rows, key tail
    (72, 96, 2, 1, 16, True, 5, 0, 32, False),
    (72, 96, 2, 1, 16, True, 0, 3, 32, False),     # rows with no key
    (72, 96, 2, 1, 16, True, 17, 9, 32, False),
    (64, 64, 2, 1, 32, True, 0, 0, 64, True),
    (40, 70, 2, 1, 320, True, 5, 3, 32, False),    # head dims of the wide
    (48, 64, 2, 1, 512, False, 0, 0, 64, False),   # kernels
]


@pytest.mark.parametrize("case", FWD, ids=lambda c: "-".join(map(str, c)))
def test_fwd_plain_matches_pallas(case):
    """Plain K2 in all three output modes against the Pallas kernel; at
    head dims 16 and 32, and at 320 and 512, where the card runs K2's wide
    kernels."""
    sq, skv, h, b, d, causal, qo, ko, bq, bf16 = case
    q, k, v = _arrays(1, (sq, h, b, d), (skv, h, b, d), (skv, h, b, d))
    kw = dict(causal=causal, q_offset=qo, kv_offset=ko)
    with F32:
        jq, jk, jv = (_jax(x, bf16) for x in (q, k, v))
        out, (m, l) = jfp.pallas_flash_attention(
            jq, jk, jv, interpret=True, block_q=bq, return_stats=True, **kw)
        parts = jfp.pallas_flash_attention(jq, jk, jv, interpret=True,
                                           block_q=bq, partials=True, **kw)
    tq, tk, tv = (_torch(x, bf16) for x in (q, k, v))
    got, (gm, gl) = flash.flash_attention_fwd(tq, tk, tv, return_stats=True,
                                              **kw)
    plain = flash.flash_attention_fwd(tq, tk, tv, **kw)
    gparts = flash.flash_attention_fwd(tq, tk, tv, partials=True, **kw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert torch.isfinite(got.float()).all()
    rows = (qo + np.arange(sq)) >= ko
    tol = 3e-2 if bf16 else 1e-5

    def close(a, want, axis):
        a = np.compress(rows, _np(a), axis=axis)
        w = np.compress(rows, np.asarray(jnp.asarray(want, jnp.float32)),
                        axis=axis)
        np.testing.assert_allclose(a, w, atol=tol, rtol=tol)

    close(got, out, 0)
    close(plain, out, 0)
    close(gm, m, 1)
    close(gl, l, 1)
    for a, w in zip(gparts[:2], parts[:2]):     # m, l: (H, B, Sq)
        close(a, w, 2)
    close(gparts[2], parts[2], 0)               # acc: (Sq, H, B, D)


# (sq, skv, causal, q_offset, kv_offset, bf16[, head dim; 16 if absent])
BWD = [
    (80, 140, False, 0, 0, False),
    (72, 96, True, 5, 3, False),
    (16, 140, True, 0, 9, False),   # several key tiles, offset origin
    (64, 64, True, 0, 0, True),
    (40, 70, True, 5, 3, False, 512),   # a head dim of the wide kernels
]


@pytest.mark.parametrize("case", BWD, ids=lambda c: "-".join(map(str, c)))
def test_bwd_plain_matches_pallas(case):
    """Plain K3 + K4 (full backward and one-block partials backward)
    against the Pallas backward kernels, from the same residuals; at head
    dim 16 and at 512, where the card runs K3/K4's wide kernels."""
    sq, skv, causal, qo, ko, bf16 = case[:6]
    h, b, d = 2, 1, case[6] if len(case) > 6 else 16
    q, k, v, do = _arrays(2, (sq, h, b, d), (skv, h, b, d), (skv, h, b, d),
                          (sq, h, b, d))
    do[(qo + np.arange(sq)) < ko] = 0.0   # defined outputs only
    kw = dict(causal=causal, q_offset=qo, kv_offset=ko)
    jq, jk, jv, jdo = (_jax(x, bf16) for x in (q, k, v, do))
    with F32:
        out, (m, l) = jfp.pallas_flash_attention(
            jq, jk, jv, interpret=True, block_q=32, return_stats=True, **kw)
        want = jfp.pallas_flash_attention_bwd(jq, jk, jv, out, jdo, m, l,
                                              interpret=True, block_q=32,
                                              **kw)
    tq, tk, tv, tdo = (_torch(x, bf16) for x in (q, k, v, do))
    tout = _torch(np.asarray(jnp.asarray(out, jnp.float32)), bf16)
    tm, tl = _torch(np.asarray(m)), _torch(np.asarray(l))
    got = flash.flash_attention_bwd(tq, tk, tv, tout, tdo, tm, tl, **kw)
    tol = 6e-2 if bf16 else 2e-5
    for g, w in zip(got, want):
        assert g.dtype == tq.dtype
        np.testing.assert_allclose(_np(g), np.asarray(jnp.asarray(
            w, jnp.float32)), atol=tol, rtol=tol)
    if bf16:
        return
    # one block of a partials accumulation, against the global residuals
    L = jnp.where(l > 0, m + jnp.log(l), jnp.inf).reshape(h, b, sq)
    D = jnp.moveaxis(jnp.sum(jdo * out, axis=-1), 0, -1)
    with F32:
        want = jfp.pallas_flash_attention_bwd_partials(
            jq, jk, jv, jdo, L, D, interpret=True, block_q=64, **kw)
    got = flash.flash_attention_bwd_partials(
        tq, tk, tv, tdo, _torch(np.asarray(L)), _torch(np.asarray(D)), **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=2e-5,
                                   rtol=2e-5)


def _loss_grads_jax(q, k, v, ct, **kw):
    def loss(q_, k_, v_):
        out = jatt.flash_attention(q_, k_, v_, impl="xla", **kw)
        return jnp.sum(out.astype(jnp.float32) * ct), out

    step = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))
    with F32:
        (_, out), grads = step(q, k, v)
    return out, grads


def _loss_grads_port(q, k, v, ct, **kw):
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = att.flash_attention(*leaves, **kw)
    (out.float() * torch.from_numpy(ct)).sum().backward()
    return out, [x.grad for x in leaves]


# (sq, skv, extra, causal, q_offset, kv_offset, impl, bf16)
FLASH = [
    (48, 48, (1, 16), False, 0, 0, "kernel", False),
    (48, 48, (1, 16), True, 0, 0, "kernel", False),
    (48, 48, (1, 16), True, 0, 0, "plain", False),
    (40, 56, (2, 3, 8), True, 7, 2, "kernel", False),     # batch dims
    (40, 56, (2, 3, 8), False, 0, 0, "plain", False),
    (64, 64, (1, 32), False, 0, 0, "kernel", True),
    (64, 64, (1, 32), True, 0, 0, "auto", True),
]


@pytest.mark.parametrize("case", FLASH, ids=lambda c: "-".join(map(str, c)))
def test_flash_attention_matches_jax(case):
    """``flash_attention`` values and gradients: the kernel path (K2 with
    K3 + K4 as its backward, plain versions on the CPU) and the plain
    streaming path differentiated by autograd."""
    sq, skv, extra, causal, qo, ko, impl, bf16 = case
    h = 2
    q, k, v, ct = _arrays(4, (sq, h) + extra, (skv, h) + extra,
                          (skv, h) + extra, (sq, h) + extra)
    ct[(qo + np.arange(sq)) < ko] = 0.0
    kw = dict(causal=causal, q_offset=qo, kv_offset=ko)
    out, grads = _loss_grads_jax(*(_jax(x, bf16) for x in (q, k, v)), ct,
                                 **kw)
    got, ggrads = _loss_grads_port(*(_torch(x, bf16) for x in (q, k, v)), ct,
                                   impl=impl, **kw)
    rows = (qo + np.arange(sq)) >= ko
    tol_fwd, tol_grad = (3e-2, 6e-2) if bf16 else (1e-5, 2e-5)
    np.testing.assert_allclose(_np(got)[rows], np.asarray(
        jnp.asarray(out, jnp.float32))[rows], atol=tol_fwd, rtol=tol_fwd)
    for g, w in zip(ggrads, grads):
        assert g.dtype == got.dtype
        np.testing.assert_allclose(_np(g), np.asarray(
            jnp.asarray(w, jnp.float32)), atol=tol_grad, rtol=tol_grad)


def test_dense_matches_jax():
    q, k, v = _arrays(6, (24, 2, 2, 8), (30, 2, 2, 8), (30, 2, 2, 8))
    with F32:
        want = jatt.dense_attention(q, k, v, causal=True, q_offset=3,
                                    kv_offset=1)
    got = att.dense_attention(_torch(q), _torch(k), _torch(v), causal=True,
                              q_offset=3, kv_offset=1)
    rows = (3 + np.arange(24)) >= 1
    np.testing.assert_allclose(_np(got)[rows], np.asarray(want)[rows],
                               atol=1e-5, rtol=1e-5)


def test_f16_masked_attention_finite():
    """float16 goes the plain way under "auto"; the masked-score value of
    its float32 scores keeps fully masked rows finite."""
    assert att._neg_value(torch.float16) > float(torch.finfo(
        torch.float16).min)
    q, k, v = (torch.from_numpy(a).half()
               for a in _arrays(16, (16, 2, 4), (16, 2, 4), (16, 2, 4)))
    for fn in (att.dense_attention,
               lambda *a, **kw: att.flash_attention(*a, chunk=4, **kw)):
        out = fn(q, k, v, causal=True, kv_offset=5)
        assert out.dtype == torch.float16
        assert torch.isfinite(out).all()


def test_fully_masked_rows_finite_on_kernel_path():
    q, k, v = (_torch(a) for a in _arrays(5, (16, 1, 8), (16, 1, 8),
                                          (16, 1, 8)))
    out = att.flash_attention(q, k, v, causal=True, kv_offset=8,
                              impl="kernel")
    assert torch.isfinite(out).all()
    m, l, acc = flash.flash_attention_fwd(q[:, :, None], k[:, :, None],
                                          v[:, :, None], causal=True,
                                          kv_offset=20, partials=True)
    assert torch.isfinite(acc).all() and torch.isfinite(m).all()


MIXES = [(a, b, c) for a in ("float32", "bfloat16")
         for b in ("float32", "bfloat16") for c in ("float32", "bfloat16")]


@pytest.mark.parametrize("mix", MIXES, ids=lambda m: "-".join(m))
@pytest.mark.parametrize("d", [8, 64, 72, 128, 256, 264, 384, 512, 1024])
def test_fwd_instance(d, mix):
    """K2's instance rule, the same at every head dim up to 1024: the bf16
    tensor-core (wgmma) instance takes q, k and v all bf16, the tf32x3 one
    any mix with an f32 operand (above d = 256 each by its wide kernel),
    and no call takes the retired simt instance.  CPU tensors run the
    plain version and launch none."""
    dtypes = [getattr(torch, name) for name in mix]
    if all(dt == torch.bfloat16 for dt in dtypes):
        want = "wgmma"
    else:
        want = "tf32x3"
    assert flash.fwd_instance(d, *dtypes) == want
    q, k, v = (_torch(a).to(dt) for a, dt in zip(
        _arrays(10, (5, 2, 1, d), (7, 2, 1, d), (7, 2, 1, d)), dtypes))
    before = (flash.launches_fwd, dict(flash.launches_fwd_by_instance),
              flash.realigned_copies)
    got = flash.flash_attention_fwd(q, k, v, causal=True, q_offset=2)
    assert (flash.launches_fwd, flash.launches_fwd_by_instance,
            flash.realigned_copies) == before
    torch.testing.assert_close(got, flash.flash_attention_fwd_plain(
        q, k, v, causal=True, q_offset=2), atol=0, rtol=0)


MIXES_BWD = [m + (e,) for m in MIXES for e in ("float32", "bfloat16")]


@pytest.mark.parametrize("mix", MIXES_BWD, ids=lambda m: "-".join(m))
@pytest.mark.parametrize("d", [8, 40, 64, 72, 128, 200, 256, 264, 384, 512,
                               1024])
def test_bwd_instance(d, mix):
    """K3/K4's instance rule, the same at every head dim up to 1024: the
    bf16 tensor-core (wgmma) instance takes q, k, v and dO all bf16, the
    tf32x3 one every mix with an f32 operand (a bf16 ring's partials with
    an f32 dO among them); above d = 256 both run their wide kernels, and
    no call takes the retired simt kernels.  CPU tensors run the plain
    versions and launch none."""
    dtypes = [getattr(torch, name) for name in mix]
    if all(dt == torch.bfloat16 for dt in dtypes):
        want = "wgmma"
    else:
        want = "tf32x3"
    assert flash.bwd_instance(d, *dtypes) == want
    q, k, v, do = (_torch(a).to(dt) for a, dt in zip(
        _arrays(11, (5, 2, 1, d), (7, 2, 1, d), (7, 2, 1, d), (5, 2, 1, d)),
        dtypes))
    L, D = (_torch(a) for a in _arrays(12, (2, 1, 5), (2, 1, 5)))
    L = L.abs() + 2.0     # a logsumexp above every row's scores
    before = (flash.launches_dq, flash.launches_dkv,
              dict(flash.launches_dq_by_instance),
              dict(flash.launches_dkv_by_instance), flash.realigned_copies)
    kw = dict(causal=True, q_offset=2)
    got = flash.flash_attention_bwd_partials(q, k, v, do, L, D, **kw)
    assert (flash.launches_dq, flash.launches_dkv,
            flash.launches_dq_by_instance, flash.launches_dkv_by_instance,
            flash.realigned_copies) == before
    want_grads = flash.flash_attention_bwd_partials_plain(q, k, v, do, L, D,
                                                          **kw)
    for g, w in zip(got, want_grads):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, w, atol=0, rtol=0)


def test_impl_routing_and_cpu_wrappers():
    """``impl`` values and errors; CPU tensors take the plain versions
    and launch nothing."""
    q, k, v = (_torch(a) for a in _arrays(8, (32, 2, 16), (32, 2, 16),
                                          (32, 2, 16)))
    before = (flash.launches_fwd, flash.launches_dq, flash.launches_dkv)
    ref = att.dense_attention(q, k, v)
    for impl in ("auto", "kernel", "plain"):
        torch.testing.assert_close(att.flash_attention(q, k, v, impl=impl),
                                   ref, atol=1e-5, rtol=1e-5)
    assert (flash.launches_fwd, flash.launches_dq,
            flash.launches_dkv) == before
    with pytest.raises(ValueError):
        att.flash_attention(q, k, v, impl="pallas")   # the JAX name
    with pytest.raises(ValueError):
        att.flash_attention(q.double(), k.double(), v.double(),
                            impl="kernel")
    with pytest.raises(ValueError):
        att.flash_attention(q, k, v.double(), impl="kernel")
    with pytest.raises(TypeError):
        att.flash_attention(q, k, v, impl="kernel", q_offset=0.5)
    d64 = att.flash_attention(q.double(), k.double(), v.double())  # plain
    assert d64.dtype == torch.float64
    torch.testing.assert_close(d64.float(), ref, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError):
        flash.flash_attention_fwd(q, k, v, partials=True)   # needs 4-D
    with pytest.raises(ValueError):
        flash.flash_attention_fwd(q[:, :, None], k[:, :, None],
                                  v[:, :, None], partials=True,
                                  return_stats=True)


def test_mixed_dtypes_take_the_kernel_path():
    """q in bfloat16 with float32 k/v, and k/v of two dtypes: ``"auto"``
    takes the kernels (their plain versions here), which read each operand
    in its own dtype; values and grads against the JAX package, whose
    routing sends such mixes to its XLA scan."""
    sq, h, d = 48, 2, 16
    q, k, v, ct = _arrays(9, (sq, h, 1, d), (sq, h, 1, d), (sq, h, 1, d),
                          (sq, h, 1, d))
    for mix in ((True, False, False), (False, True, False)):
        out, grads = _loss_grads_jax(*(_jax(x, bf) for x, bf in
                                       zip((q, k, v), mix)), ct, causal=True)
        before = flash.launches_fwd
        got, ggrads = _loss_grads_port(*(_torch(x, bf) for x, bf in
                                         zip((q, k, v), mix)), ct,
                                       causal=True, impl="kernel")
        assert flash.launches_fwd == before   # CPU tensors: plain versions
        assert got.dtype == (torch.bfloat16 if mix[0] else torch.float32)
        np.testing.assert_allclose(_np(got), np.asarray(
            jnp.asarray(out, jnp.float32)), atol=3e-2, rtol=3e-2)
        for g, w, bf in zip(ggrads, grads, mix):
            assert g.dtype == (torch.bfloat16 if bf else torch.float32)
            np.testing.assert_allclose(_np(g), np.asarray(
                jnp.asarray(w, jnp.float32)), atol=6e-2, rtol=6e-2)


def _tf32(x):
    """float32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` does: 10
    mantissa bits, to nearest with ties away from zero (the magnitude's
    low 13 bits rounded up at half, then cleared)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _rz(x):
    """float64 ``x`` rounded to float32 toward zero."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(),
                       torch.nextafter(y, torch.zeros_like(y)), y)


def _mm(a, b, passes, block):
    """float32 ``a @ b`` as the tf32x3 kernels sum it on the tensor cores.
    Each operand is split into ``big = tf32(x)`` and ``small = tf32(x -
    big)``; per k8 step the products small·big, big·small and big·big
    (``passes=3``; ``passes=1``: big·big alone, single-pass TF32) go in
    turn into an f32 accumulator, each step's exact sum added to it and
    rounded toward zero, as ``mma.sync`` accumulates; a fresh accumulator
    takes every ``block`` terms of k, and one float32 add (to nearest)
    moves its sum into the result."""
    ab, bb = _tf32(a), _tf32(b)
    prods = [(ab, bb)]
    if passes == 3:
        prods = [(_tf32(a - ab), bb), (ab, _tf32(b - bb)), (ab, bb)]
    n = a.shape[-1]
    out = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k0 in range(0, n, block):
        part = torch.zeros_like(out)
        for k in range(k0, min(k0 + block, n), 8):
            for x, y in prods:
                part = _rz(part.double() + x[..., k:k + 8].double()
                           @ y[..., k:k + 8, :].double())
        out = out + part
    return out


def _tf32x3_bwd(q, k, v, do, L, D, *, causal, q_offset, kv_offset,
                passes=3, chunk=32, block=32):
    """The arithmetic of K3 and K4's tf32x3 instance on folded (S, N, D)
    float32 tensors: S and dP as split products summed ``chunk`` columns a
    fresh accumulator, P = exp2(S·scale·log2 e - L·log2 e) (one rounding,
    as fmaf) masked before the exp, dS = P∘(dP - D), then dQ = scale·dS·K,
    dV = Pᵀ·dO, dK = scale·dSᵀ·Q as split products of the f32 P and dS
    summed ``block`` keys (q rows) a fresh accumulator: the streamed tile,
    32 rows for d <= 128 and above 256.  Above d = 256 the kernels stream S
    and dP over the head dim in slabs of two 32-column chunks and add each
    chunk's sum in turn: the order modelled here for every d."""
    sq, n, d = q.shape
    scale = np.float32(1.0 / np.sqrt(d))
    log2e = np.float32(1.4426950408889634)
    qh, kh, vh, doh = (x.permute(1, 0, 2) for x in (q, k, v, do))
    s = _mm(qh, kh.transpose(1, 2), passes, chunk)
    dp = _mm(doh, vh.transpose(1, 2), passes, chunk)
    rows = q_offset + torch.arange(sq)[:, None]
    cols = kv_offset + torch.arange(k.shape[0])[None, :]
    valid = (rows >= cols) if causal else torch.ones_like(rows >= cols)
    arg = (s.double() * float(scale * log2e)
           - (L * log2e).double()[..., None]).float()
    p = torch.where(valid, torch.exp2(arg), 0.0)
    ds = p * (dp - D[..., None])
    dq = _mm(ds, kh, passes, block) * scale
    dk = _mm(ds.transpose(1, 2), qh, passes, block) * scale
    dv = _mm(p.transpose(1, 2), doh, passes, block)
    return tuple(x.permute(1, 0, 2) for x in (dq, dk, dv))


def _tf32x3_errs(sq, skv, n, d, seed, kw, **how):
    """Per-row errors (chip_smoke's _rel_err, each row of dq and dk held
    to the larger of its own max|exact| and its largest term) of the
    emulated tf32x3 backward against the plain backward in float64."""
    from chip_smoke import _bwd_terms, _rel_err

    q, k, v, do = (torch.from_numpy(a) for a in _arrays(
        seed, (sq, n, d), (skv, n, d), (skv, n, d), (sq, n, d)))
    rows = (kw["q_offset"] + np.arange(sq)) >= kw["kv_offset"]
    do[~torch.from_numpy(rows)] = 0.0   # defined outputs only
    out, (m, l) = flash.flash_attention_fwd_plain(
        q.double(), k.double(), v.double(), return_stats=True, **kw)
    want = flash.flash_attention_bwd_plain(
        q.double(), k.double(), v.double(), out, do.double(), m, l, **kw)
    L, D = (x.float() for x in flash.residuals(out, do.double(), m, l))
    terms = _bwd_terms(torch, flash, q, k, v, do, L, D, **kw) + (None,)
    got = _tf32x3_bwd(q, k, v, do, L, D, **kw, **how)
    return [_rel_err(torch, g, w, terms=t)
            for g, w, t in zip(got, want, terms)]


@pytest.mark.parametrize("shape,offsets,without", [
    ((45, 67, 3, 64), (False, 0, 0), dict(passes=1)),
    ((45, 67, 3, 64), (True, 0, 0), dict(passes=1)),
    ((45, 67, 3, 64), (True, 5, 0), dict(passes=1)),
    ((45, 67, 3, 64), (True, 17, 9), dict(passes=1)),
    ((16, 8192, 2, 128), (False, 0, 0), dict(block=8192)),
    ((45, 67, 3, 320), (True, 17, 9), dict(passes=1)),   # the wide kernels
    ((45, 67, 3, 512), (False, 0, 0), dict(passes=1)),
])
def test_tf32x3_split_meets_the_f32_tolerance(shape, offsets, without):
    """The numerical case for the tf32x3 instance, checked without a card:
    its arithmetic, emulated in torch with TF32 rounding as cvt.rna does
    and the accumulation as mma.sync does it, stays about 2e-6 of each
    row's scale from the plain backward in float64, within a fifth of the
    f32 backward bar of chip_smoke.py (5e-5); without each part of the
    design it misses that bar: single-pass TF32 at a small ragged shape,
    and (mma.sync rounding its accumulation toward zero) one accumulator
    for the products of 8192 keys in place of a fresh one per streamed
    tile, whose dq drifts to about 1e-4."""
    kw = dict(zip(("causal", "q_offset", "kv_offset"), offsets))
    errs = _tf32x3_errs(*shape, 21, kw)
    errs_without = _tf32x3_errs(*shape, 21, kw, **without)
    assert max(errs) <= 1e-5, errs
    assert max(errs_without) > 5e-5, errs_without


def _chain(acc, a, b, passes):
    """float32 ``acc + a @ b`` as one mma.sync accumulator chain: per k8
    step the split products (as ``_mm``) each added to ``acc`` and rounded
    toward zero."""
    ab, bb = _tf32(a), _tf32(b)
    prods = [(ab, bb)]
    if passes == 3:
        prods = [(_tf32(a - ab), bb), (ab, _tf32(b - bb)), (ab, bb)]
    for k in range(0, a.shape[-1], 8):
        for x, y in prods:
            acc = _rz(acc.double() + x[..., k:k + 8].double()
                      @ y[..., k:k + 8, :].double())
    return acc


def _tf32x3_fwd(q, k, v, *, causal, q_offset, kv_offset, passes=3,
                one_s=False, one_o=False, round_p=False):
    """The arithmetic of K2's tf32x3 instance on folded (S, N, D) float32
    tensors (``round_p``: P rounded to bf16 after the row sum, as the
    kernel does for a bf16 v).  S = Q·Kᵀ by 32-column chunks, each
    chunk's split products a fresh accumulator chain.  Up to d = 256 the
    chunks' sums are added in order with float32 adds (to nearest); above
    (the wide kernel) the two warp groups take the 32-column boxes in
    pairs by turns (4 s, 4 s + 1 and 4 s + 2, 4 s + 3), each adds its
    boxes in order, and S is the sum of the two groups' parts.  Then per
    key tile (chip_smoke.tf32_fwd_keys: 64 keys up to d = 64, 16 at
    128 < d <= 256, else 32) the online softmax (running max m, corr =
    exp2((m_old - m)·log2 e), P = exp2(S·scale·log2 e - m·log2 e) as one
    fmaf, l = l·corr + rowsum P) and O = O·corr + P·V, P·V of the tile a fresh
    accumulator chain.  ``one_s``: one chain over the whole head dim in
    place of a fresh one per chunk; ``one_o``: O itself the chain over
    all keys; ``passes=1``: single-pass TF32."""
    from chip_smoke import tf32_fwd_keys

    sq, n, d = q.shape
    skv = k.shape[0]
    bk = tf32_fwd_keys(d)
    scale = np.float32(1.0 / np.sqrt(d))
    log2e = np.float32(1.4426950408889634)
    qh, vh = q.permute(1, 0, 2), v.permute(1, 0, 2)
    kt = k.permute(1, 2, 0)
    zero = torch.zeros((n, sq, skv))
    if one_s:
        s = _chain(zero, qh, kt, passes)
    else:
        part = [zero, zero]
        for b in range((d + 31) // 32):
            c = slice(32 * b, 32 * b + 32)
            g = (b // 2) % 2 if d > 256 else 0
            part[g] = part[g] + _chain(zero, qh[..., c], kt[:, c], passes)
        s = part[0] + part[1]
    rows = q_offset + torch.arange(sq)[:, None]
    m = torch.full((n, sq), flash.NEG)
    l = torch.zeros((n, sq))
    acc = torch.zeros((n, sq, d))
    for c0 in range(0, skv, bk):
        x = s[..., c0:c0 + bk] * scale
        if causal:
            cols = kv_offset + c0 + torch.arange(x.shape[-1])[None, :]
            x = torch.where(rows >= cols, x, torch.tensor(flash.NEG))
        mn = torch.maximum(m, x.amax(-1))
        corr = torch.exp2((m - mn) * log2e)
        p = torch.exp2((x.double() * float(log2e)
                        - (mn * log2e).double()[..., None]).float())
        l = l * corr + p.sum(-1)
        if round_p:
            p = p.bfloat16().float()
        acc = acc * corr[..., None]
        if one_o:
            acc = _chain(acc, p, vh[:, c0:c0 + bk], passes)
        else:
            acc = acc + _chain(torch.zeros_like(acc), p, vh[:, c0:c0 + bk],
                               passes)
        m = mn
    return (acc / l[..., None]).permute(1, 0, 2), m, l


def _tf32x3_fwd_errs(sq, skv, n, d, seed, kw, **how):
    """Per-row errors (chip_smoke's _rel_err; m held to the larger of its
    own max|exact| and its largest term, as flash_compare holds it) of the
    emulated tf32x3 forward's out, m and l against the plain forward in
    float64, on the rows that see a key."""
    from chip_smoke import _rel_err

    q, k, v = (torch.from_numpy(a) for a in _arrays(
        seed, (sq, n, d), (skv, n, d), (skv, n, d)))
    rows = torch.from_numpy((kw["q_offset"] + np.arange(sq))
                            >= kw["kv_offset"])
    out, (m, l) = flash.flash_attention_fwd_plain(
        q.double(), k.double(), v.double(), return_stats=True, **kw)
    got, gm, gl = _tf32x3_fwd(q, k, v, **kw, **how)
    m_terms = q.abs().amax(-1) * float(k.abs().max()) / np.sqrt(d)
    return [_rel_err(torch, got, out, rows),
            _rel_err(torch, gm.t(), m.t(), rows, m_terms),
            _rel_err(torch, gl.t(), l.t(), rows)]


@pytest.mark.parametrize("shape,offsets,without", [
    ((45, 67, 3, 64), (True, 17, 9), dict(passes=1)),   # up to d = 256
    ((45, 67, 3, 128), (True, 5, 0), dict(passes=1)),
    ((45, 67, 3, 256), (True, 17, 9), dict(passes=1)),
    ((16, 8192, 2, 64), (True, 8192, 0), dict(one_o=True)),
    ((16, 8192, 2, 128), (False, 0, 0), dict(one_o=True)),
    ((16, 8192, 2, 256), (True, 8192, 0), dict(one_o=True)),
    ((45, 67, 3, 320), (True, 17, 9), dict(passes=1)),   # the wide kernel
    ((45, 67, 3, 512), (False, 0, 0), dict(passes=1)),
    ((45, 67, 3, 512), (True, 5, 0), dict(passes=1)),
    ((45, 67, 3, 1024), (False, 0, 0), dict(one_s=True)),
    ((16, 8192, 2, 320), (False, 0, 0), dict(one_o=True)),
    ((16, 8192, 2, 512), (True, 8192, 0), dict(one_o=True)),
])
def test_tf32x3_fwd_split_meets_the_f32_tolerance(shape, offsets, without):
    """The numerical case for K2's tf32x3 instance, up to d = 256 and its
    wide kernel above, checked without a card: its arithmetic, emulated in
    torch with TF32 rounding as cvt.rna does it, the accumulation as
    mma.sync does it (toward zero) and the kernel's own chunks, group
    order and key tiles, stays within 5e-6 of each row's scale (about
    1.6e-6) from the plain forward in float64, half of K2's f32 bar in
    chip_smoke.py (1e-5); without each part of the design it misses that
    bar: single-pass TF32, one accumulator chain over the head dim where
    it is long (d = 1024: 192 truncating adds a score at d = 512 already
    reach about 1.1e-5) in place of a fresh one per 32-column chunk, and
    one over 8192 keys (O's whole history, about 1e-4) in place of a
    fresh one per key tile."""
    kw = dict(zip(("causal", "q_offset", "kv_offset"), offsets))
    errs = _tf32x3_fwd_errs(*shape, 21, kw)
    errs_without = _tf32x3_fwd_errs(*shape, 21, kw, **without)
    assert max(errs) <= 5e-6, errs
    assert max(errs_without) > 1e-5, errs_without


@pytest.mark.parametrize("d,offsets", [
    (64, (True, 17, 9)), (256, (True, 5, 0)), (320, (True, 17, 9)),
    (512, (False, 0, 0)), (1024, (True, 5, 0))])
def test_tf32x3_fwd_rounds_p_for_bf16_v(d, offsets):
    """chip_smoke.py's bar for P's rounding in K2's tf32x3 instance on a
    bf16 v (_p_rounding), checked on the kernel's emulated arithmetic:
    with P rounded to bf16 as the kernel rounds it, the mean of the rows'
    worst errors against the plain version in float64 that rounds P in
    the same key tiles stays under a quarter of that version's distance
    from the one that does not round; with P left unrounded it does not."""
    from chip_smoke import _rel_err, tf32_fwd_keys

    kw = dict(zip(("causal", "q_offset", "kv_offset"), offsets))
    q, k, v = (torch.from_numpy(a) for a in _arrays(
        23, (45, 3, d), (67, 3, d), (67, 3, d)))
    v = v.bfloat16().float()
    rows = torch.from_numpy((kw["q_offset"] + np.arange(45))
                            >= kw["kv_offset"])

    def plain(p_dtype):
        m, l, acc = flash.stream_stats(
            q.double(), k.double(), v.double(), chunk=tf32_fwd_keys(d),
            score_dtype=torch.float64, p_dtype=p_dtype, **kw)
        return flash.normalize(l, acc, torch.float64)

    rounded = plain(torch.bfloat16)
    dist = _rel_err(torch, plain(None), rounded, rows, mean=True)
    err, err_without = (
        _rel_err(torch, _tf32x3_fwd(q, k, v, **kw, round_p=r)[0], rounded,
                 rows, mean=True) for r in (True, False))
    assert err <= dist / 4, (err, dist)
    assert err_without > dist / 4, (err_without, dist)
