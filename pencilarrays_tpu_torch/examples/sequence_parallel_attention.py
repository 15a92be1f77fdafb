"""Sequence-parallel attention on pencil primitives.  The pencil
transpose IS the Ulysses all-to-all head/sequence reshard; the ring's
point-to-point rotation IS ring attention's k/v streaming.  Both schemes
give the same softmax attention as the dense reference, and the zigzag
causal ring (about half the causal FLOPs) the same causal attention.
The twin of the JAX package's ``examples/sequence_parallel_attention.py``
(which runs float32 only)::

    python -m pencilarrays_tpu_torch.examples.sequence_parallel_attention [--device cpu]

On the card the local attention is kernel K2 (``ops/csrc/flash_fwd.cu``)
and the Ulysses hops move through K1.
"""

from __future__ import annotations

import numpy as np
import torch

import pencilarrays_tpu_torch as pat
from pencilarrays_tpu_torch.models import (dense_attention, from_zigzag,
                                           ring_attention, to_zigzag,
                                           ulysses_attention)

from . import _launch

SIZES = {"seq": 4096, "heads": 8, "head_dim": 128,
         "dtypes": "float32,bfloat16"}
# each row (one position of one head) against the dense reference,
# relative to its own max|dense| floored at 1e-3 of the tensor's max
# (chip_smoke.py's serving bars): f32 and bf16 (the kernel rounds P and
# the output, half an ulp each)
TOL = {"float32": 2e-5, "bfloat16": 2 ** -6}
SEED = 0            # the JAX script's numpy seed


def row_rel_err(got: np.ndarray, want: np.ndarray) -> float:
    """Worst error of ``got`` against ``want`` over the last dim's rows,
    each relative to its own max|want| (floored at 1e-3 max|want|)."""
    got, want = got.astype(np.float64), want.astype(np.float64)
    floor = 1e-3 * float(np.abs(want).max()) or 1.0
    scale = np.maximum(np.abs(want).max(axis=-1, keepdims=True), floor)
    return float((np.abs(got - want) / scale).max())


def run(device=None, seq=SIZES["seq"], heads=SIZES["heads"],
        head_dim=SIZES["head_dim"], dtypes=SIZES["dtypes"]) -> dict:
    """Ulysses, ring and zigzag causal ring on the (S, H) pencil
    decomposed along S over every rank, per dtype of ``dtypes`` (names
    joined by commas), each against dense attention of the same
    operands in float32."""
    P = pat.distributed.process_count()
    S, H, D = int(seq), int(heads), int(head_dim)
    topo = pat.Topology((P,), device=device)
    pen = pat.Pencil(topo, (S, H), (0,))
    rng = np.random.default_rng(SEED)
    host = [rng.standard_normal((S, H, D)).astype(np.float32)
            for _ in range(3)]
    small = S * H * D <= _launch.GATHER_MAX   # fields in the result
    out = {"seq": S, "heads": H, "head_dim": D, "ranks": P,
           "zigzag_flop_share": (4 * P + 2) / (8 * P)}
    for name in dtypes.split(","):
        dtype = getattr(torch, name)
        q, k, v = (pat.PencilArray.from_global(pen, a, extra_ndims=1)
                   .astype(dtype) for a in host)
        got = {"ulysses": ulysses_attention(q, k, v),
               "ring": ring_attention(q, k, v),
               "zigzag": from_zigzag(ring_attention(
                   *map(to_zigzag, (q, k, v)), causal=True, zigzag=True))}
        gathered = {s: pat.gather(x.astype(torch.float32))
                    for s, x in got.items()}
        gq, gk, gv = (pat.gather(x.astype(torch.float32)) for x in (q, k, v))
        if not _launch.is_root():
            continue
        ref = {c: dense_attention(*(torch.from_numpy(a).to(topo.device)
                                    for a in (gq, gk, gv)),
                                  causal=c).cpu().numpy()
               for c in (False, True)}
        for scheme, g in gathered.items():
            err = row_rel_err(g, ref[scheme == "zigzag"])
            if not (np.isfinite(g).all() and err <= TOL[name]):
                raise AssertionError(f"{scheme} {name}: rel err {err} "
                                     f"against dense > {TOL[name]}")
            out[f"{scheme}_{name}_rel_err"] = err
            if small:
                out[f"{scheme}_{name}"] = g
        if small:
            out[f"dense_{name}"] = ref[False]
            out[f"dense_causal_{name}"] = ref[True]
    return out


def main(argv=None) -> int:
    return _launch.main(__spec__.name, __doc__, SIZES, argv)


if __name__ == "__main__":
    raise SystemExit(main())
