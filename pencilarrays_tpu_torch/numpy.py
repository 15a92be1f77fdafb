"""``pencilarrays_tpu_torch.numpy`` — the wrapped elementwise namespace.

PyTorch counterpart of the JAX package's ``numpy.py``::

    import pencilarrays_tpu_torch.numpy as pnp
    y = pnp.cos(u)              # PencilArray, same pencil, no communication
    z = pnp.add(u, v)           # operands validated to share the pencil
    w = pnp.where(u > 0, u, 0.0)

Each name runs the torch function of the same NumPy meaning on the
memory-order padded blocks (the reference's broadcast on parents,
``broadcast.jl:31-57``).  Only ELEMENTWISE functions are exposed: they
are layout-invariant, so the tail padding stays inert.  Reductions live
in :mod:`pencilarrays_tpu_torch.ops.reductions` (padding-masked, global);
anything else is spelled on ``.data`` (memory order) or ``.logical()``.
Raw-array operands align to the logical global shape under NumPy's
broadcasting (:meth:`PencilArray.align`), the same ``lead`` rule as the
JAX package.
"""

from __future__ import annotations

import torch

from .parallel.arrays import PencilArray, torch_elementwise

# Elementwise NumPy names that torch computes
_ELEMENTWISE = frozenset("""
abs absolute add arccos arccosh arcsin arcsinh arctan arctan2 arctanh
bitwise_and bitwise_not bitwise_or bitwise_xor ceil clip conj conjugate
copysign cos cosh deg2rad degrees divide equal exp exp2 expm1 fmax fmin
fmod float_power floor floor_divide greater greater_equal heaviside hypot
i0 imag invert isfinite isinf isnan ldexp less less_equal log log10 log1p
log2 logaddexp logaddexp2 logical_and logical_not logical_or logical_xor
maximum minimum mod multiply negative nextafter not_equal positive power
rad2deg radians real reciprocal remainder rint sign signbit sin sinc sinh
sqrt square subtract tan tanh true_divide trunc where
""".split())

# Reductions and other axis-dependent names get a pointed redirect.
_REDUCTIONS = frozenset("""
sum mean prod min max amin amax std var median average all any argmin
argmax count_nonzero nanmin nanmax nansum nanmean linalg norm dot vdot
cumsum cumprod sort argsort
""".split())

_SPECIAL = {"real": torch.real, "imag": lambda x: x.imag if x.is_complex()
            else torch.zeros_like(x), "where": torch.where,
            "clip": torch.clip}


def _wrap(name):
    fn = _SPECIAL.get(name) or torch_elementwise(name)

    def convert(a, lead):
        # one rule for positional AND keyword operands: same-pencil blocks
        # pass through, scalars stay, raw arrays align to the logical shape
        if isinstance(a, PencilArray):
            if a.pencil != lead.pencil or a.extra_dims != lead.extra_dims:
                raise ValueError(
                    f"{name}: operands live on different pencils/extra "
                    f"dims; transpose first")
            return a.data
        if isinstance(a, (int, float, complex, bool)) or a is None:
            return a
        return lead.align(a)

    def call(*args, **kwargs):
        every = list(args) + list(kwargs.values())
        lead = next((a for a in every if isinstance(a, PencilArray)), None)
        if lead is None:      # plain torch behaviour
            return fn(*(a if isinstance(a, torch.Tensor) or a is None
                        else torch.as_tensor(a) for a in args), **kwargs)
        conv = [convert(a, lead) for a in args]
        kconv = {k: convert(v, lead) for k, v in kwargs.items()}
        if name not in ("where", "clip"):
            # torch's functions take tensors where NumPy takes scalars too
            conv = [torch.as_tensor(a, device=lead.device)
                    if isinstance(a, (int, float, complex, bool)) else a
                    for a in conv]
        out = fn(*conv, **kconv)
        if not isinstance(out, torch.Tensor) or \
                tuple(out.shape) != tuple(lead.data.shape):
            # e.g. single-argument where() returns index tuples, which over
            # the padded memory-order block would be wrong anyway
            raise TypeError(
                f"{name}: this call form is not elementwise over the pencil "
                f"block (result {type(out).__name__} vs block shape "
                f"{tuple(lead.data.shape)}); operate on u.logical() "
                f"explicitly")
        return PencilArray(lead.pencil, out, lead.extra_dims)

    call.__name__ = name
    call.__qualname__ = name
    call.__doc__ = (f"Wrapped elementwise ``{name}`` on PencilArray blocks "
                    f"(memory order, stays wrapped).")
    return call


def __getattr__(name):
    if name in _ELEMENTWISE:
        wrapped = _wrap(name)
        globals()[name] = wrapped  # cache: next access is a dict hit
        return wrapped
    if name in _REDUCTIONS:
        raise AttributeError(
            f"pencilarrays_tpu_torch.numpy has no {name!r}: axis-dependent "
            f"reductions must be padding-masked and global — use "
            f"pencilarrays_tpu_torch.ops.{name} (or np.{name}(u), which "
            f"dispatches to the masked implementation)")
    raise AttributeError(
        f"pencilarrays_tpu_torch.numpy exposes only elementwise functions "
        f"(layout-invariant on pencil blocks); {name!r} is not one. "
        f"Operate on u.data (memory order) or u.logical() explicitly.")


def __dir__():
    return sorted(_ELEMENTWISE)
