"""Index-permutation algebra (PyTorch port).

Copy of the JAX package's ``utils/permutations.py``, kept separate so the
port imports nothing of the JAX package.  It is pure Python: a
:class:`Permutation` is a frozen, hashable object that selects which
permute the pencil code emits; it never touches tensor data.

Conventions (0-based, matching Julia's StaticPermutations semantics shifted
down by one):

* ``Permutation(2, 0, 1).apply(t) == (t[2], t[0], t[1])`` — i.e. entry ``k``
  of the result is ``t[perm[k]]``.  This mirrors the reference where
  ``Permutation(2,3,1) * (x1,x2,x3) == (x2,x3,x1)``.
* ``invapply`` is the reference's ``perm \\ x``: the unique ``s`` with
  ``apply(perm, s) == x``.
* ``mul`` composes: ``(p * q).apply(t) == p.apply(q.apply(t))``.

:class:`NoPermutation` is the identity singleton, kept distinct (like the
reference's ``NoPermutation``) so "no permutation" is representable and cheap
to test for.
"""

from __future__ import annotations

from typing import Iterator, Sequence, Tuple, Union

__all__ = [
    "AbstractPermutation",
    "Permutation",
    "NoPermutation",
    "NO_PERMUTATION",
    "as_permutation",
    "identity_permutation",
]


class AbstractPermutation:
    """Common interface for :class:`Permutation` and :class:`NoPermutation`."""

    __slots__ = ()

    # -- queries ---------------------------------------------------------
    def is_identity(self) -> bool:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    # -- algebra ---------------------------------------------------------
    def apply(self, t: Sequence) -> tuple:
        """Reference ``perm * x`` — permute a tuple into *memory* order."""
        raise NotImplementedError

    def invapply(self, t: Sequence) -> tuple:
        """Reference ``perm \\ x`` — undo :meth:`apply` (memory → logical)."""
        raise NotImplementedError

    def inverse(self) -> "AbstractPermutation":
        raise NotImplementedError

    def __mul__(self, other: "AbstractPermutation") -> "AbstractPermutation":
        raise NotImplementedError

    def __truediv__(self, other: "AbstractPermutation") -> "AbstractPermutation":
        """Relative permutation ``self / other``: the ``r`` with
        ``r * other == self`` (cf. ``Transpositions.jl:506`` where the unpack
        kernel applies ``perm_o / perm_i``)."""
        return self * other.inverse()

    def append(self, n_extra: int) -> "AbstractPermutation":
        """Identity-extend by ``n_extra`` trailing axes (reference ``append``;
        used for PencilArray *extra dims*, which are never permuted,
        ``src/arrays.jl:34-47``)."""
        raise NotImplementedError

    def prepend(self, n_extra: int) -> "AbstractPermutation":
        """Identity-extend by ``n_extra`` leading axes."""
        raise NotImplementedError

    # -- misc ------------------------------------------------------------
    def axes(self) -> Tuple[int, ...]:
        """The permutation as an axes tuple usable by ``Tensor.permute``."""
        raise NotImplementedError


class Permutation(AbstractPermutation):
    """A concrete compile-time permutation of ``N`` indices (0-based)."""

    __slots__ = ("_perm",)

    def __init__(self, *perm: int):
        if len(perm) == 1 and isinstance(perm[0], (tuple, list)):
            perm = tuple(perm[0])
        p = tuple(int(i) for i in perm)
        if sorted(p) != list(range(len(p))):
            raise ValueError(f"invalid permutation of 0..{len(p)-1}: {p}")
        self._perm = p

    # -- queries ---------------------------------------------------------
    @property
    def indices(self) -> Tuple[int, ...]:
        return self._perm

    def is_identity(self) -> bool:
        return self._perm == tuple(range(len(self._perm)))

    def __len__(self) -> int:
        return len(self._perm)

    def __iter__(self) -> Iterator[int]:
        return iter(self._perm)

    def __getitem__(self, i: int) -> int:
        return self._perm[i]

    # -- algebra ---------------------------------------------------------
    def apply(self, t: Sequence) -> tuple:
        if len(t) != len(self._perm):
            raise ValueError(
                f"length mismatch: permutation of {len(self._perm)} applied to "
                f"tuple of length {len(t)}"
            )
        return tuple(t[i] for i in self._perm)

    def invapply(self, t: Sequence) -> tuple:
        if len(t) != len(self._perm):
            raise ValueError(
                f"length mismatch: permutation of {len(self._perm)} applied to "
                f"tuple of length {len(t)}"
            )
        out = [None] * len(t)
        for k, i in enumerate(self._perm):
            out[i] = t[k]
        return tuple(out)

    def inverse(self) -> "Permutation":
        return Permutation(self.invapply(tuple(range(len(self._perm)))))

    def __mul__(self, other: AbstractPermutation) -> AbstractPermutation:
        if isinstance(other, NoPermutation):
            return self
        if not isinstance(other, Permutation):
            return NotImplemented
        # (p * q).apply(t) == p.apply(q.apply(t)):
        #   p.apply(q.apply(t))[k] = t[q[p[k]]]  =>  (p*q)[k] = q[p[k]]
        return Permutation(self.apply(other._perm))

    def append(self, n_extra: int) -> "Permutation":
        n = len(self._perm)
        return Permutation(self._perm + tuple(range(n, n + n_extra)))

    def prepend(self, n_extra: int) -> "Permutation":
        return Permutation(
            tuple(range(n_extra)) + tuple(i + n_extra for i in self._perm)
        )

    def axes(self) -> Tuple[int, ...]:
        return self._perm

    # -- misc ------------------------------------------------------------
    def __eq__(self, other) -> bool:
        if isinstance(other, Permutation):
            return self._perm == other._perm
        if isinstance(other, NoPermutation):
            return self.is_identity()
        return NotImplemented

    def __hash__(self) -> int:
        # eq/hash contract: identity Permutation == NoPermutation, so they
        # must hash identically.
        if self.is_identity():
            return hash("NoPermutation")
        return hash(("Permutation", self._perm))

    def __repr__(self) -> str:
        return f"Permutation{self._perm}"


class NoPermutation(AbstractPermutation):
    """Identity permutation of unspecified length (reference
    ``NoPermutation``).  Applying it returns its argument unchanged."""

    __slots__ = ()
    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def is_identity(self) -> bool:
        return True

    def __len__(self) -> int:
        raise TypeError("NoPermutation has no fixed length")

    def apply(self, t: Sequence) -> tuple:
        return tuple(t)

    def invapply(self, t: Sequence) -> tuple:
        return tuple(t)

    def inverse(self) -> "NoPermutation":
        return self

    def __mul__(self, other: AbstractPermutation) -> AbstractPermutation:
        return other

    def append(self, n_extra: int) -> "NoPermutation":
        return self

    def prepend(self, n_extra: int) -> "NoPermutation":
        return self

    def axes(self) -> Tuple[int, ...]:
        raise TypeError("NoPermutation has no fixed length; use as_permutation")

    def __eq__(self, other) -> bool:
        if isinstance(other, NoPermutation):
            return True
        if isinstance(other, Permutation):
            return other.is_identity()
        return NotImplemented

    def __hash__(self) -> int:
        return hash("NoPermutation")

    def __repr__(self) -> str:
        return "NoPermutation()"


NO_PERMUTATION = NoPermutation()

PermutationLike = Union[AbstractPermutation, Sequence[int], None]


def identity_permutation(n: int) -> Permutation:
    return Permutation(tuple(range(n)))


def as_permutation(p: PermutationLike, ndim: int) -> AbstractPermutation:
    """Normalize ``None`` / tuples / AbstractPermutation to an
    :class:`AbstractPermutation` valid for ``ndim`` axes."""
    if p is None:
        return NO_PERMUTATION
    if isinstance(p, NoPermutation):
        return p
    if isinstance(p, Permutation):
        if len(p) != ndim:
            raise ValueError(f"permutation {p} incompatible with ndim={ndim}")
        # Normalize: identity permutations collapse to the singleton so that
        # descriptors differing only in identity-spelling are identical.
        return NO_PERMUTATION if p.is_identity() else p
    return as_permutation(Permutation(tuple(p)), ndim)
