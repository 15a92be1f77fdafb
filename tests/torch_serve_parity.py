"""The serve parity harness: one scenario of ``torch_serve_scenarios.py``
through the JAX package (its 8-device CPU mesh) and through the port (a
``(1, 1)``-style topology in this process, or the first ranks of the
shared gloo pool), each from a clean state, and the two results compared:
arrays under ``"fft"`` within the FFT parity tolerance of
``tests/test_torch_fft.py`` (2e-5 of the reference's largest magnitude in
single precision, 1e-10 in double), arrays under ``"bits"`` bit for bit,
everything else equal.  A scenario's argument ``"<tmp>"`` becomes a
directory of the run's own.
"""

import json
import math

import numpy as np

import torch_serve_scenarios as S


def _args(args, d):
    return [d if a == "<tmp>" else a for a in args]


def run_jax(name, *args, tmp):
    d = tmp / "jax"
    d.mkdir(parents=True, exist_ok=True)
    P = S.SPkg("jax")
    P.reset()
    try:
        return S.SCENARIOS[name](P, *_args(args, d))
    finally:
        P.reset()


def run_port(name, *args, tmp, pool_dims=None):
    """The port's run: in this process, or on the pool's first
    ``prod(pool_dims)`` ranks."""
    if pool_dims is not None and math.prod(pool_dims) > 1:
        import torch_rank_tasks as tasks

        out = tasks.shared_pool().run(tasks.serve_scenario,
                                      tuple(pool_dims), name, list(args),
                                      str(tmp / "port"))
        return out[0]
    d = tmp / "port"
    d.mkdir(parents=True, exist_ok=True)
    P = S.SPkg("torch")
    P.reset()
    try:
        return S.SCENARIOS[name](P, *_args(args, d))
    finally:
        P.reset()


def _canon(x):
    return json.loads(json.dumps(x, sort_keys=True, default=str))


def compare(want, got):
    """``got`` (the port's) against ``want`` (JAX's), key by key."""
    assert set(want) == set(got), (sorted(want), sorted(got))
    for key in want:
        if key == "fft":
            for name, w in want[key].items():
                g = got[key][name]
                assert g.shape == w.shape, (name, g.shape, w.shape)
                tol = 1e-10 if w.dtype in (np.float64, np.complex128) \
                    else 2e-5
                err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
                assert err <= tol, (name, err)
        elif key == "bits":
            for name, w in want[key].items():
                assert np.array_equal(got[key][name], w), name
        elif key == "records":
            w, g = _canon(want[key]), _canon(got[key])
            assert len(w) == len(g), (len(w), len(g), w, g)
            for i, (a, b) in enumerate(zip(w, g)):
                assert a == b, (i, a, b)
        else:
            assert _canon(got[key]) == _canon(want[key]), \
                (key, _canon(want[key]), _canon(got[key]))


def both(name, *args, tmp, pool_dims=None):
    """Run ``name`` through both packages and compare; returns both."""
    want = run_jax(name, *args, tmp=tmp)
    got = run_port(name, *args, tmp=tmp, pool_dims=pool_dims)
    compare(want, got)
    return want, got
