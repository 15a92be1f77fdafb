"""Long-context training on the pencil mesh: one causal attention block
trained end to end with sequence parallelism.  The activations live
sequence-decomposed in zigzag placement (converted once, never per
step), the forward runs the balanced zigzag ring schedule, and autograd
routes the loss cotangent back through the ring's exchanges to
replicated D x D projection weights, whose gradients are summed over the
ranks.  The twin of the JAX package's ``examples/long_context_training.py``
(which trains float32 only)::

    python -m pencilarrays_tpu_torch.examples.long_context_training [--device cpu]

On the card the forward is kernel K2 and the backward K3 and K4
(``ops/csrc/flash_*.cu``); ``chip_smoke.py`` phase 8 trains through
:func:`loss_and_grads` and :func:`sgd`.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

import pencilarrays_tpu_torch as pat
from pencilarrays_tpu_torch.models import ring_attention, to_zigzag

from . import _launch

SIZES = {"seq": 4096, "heads": 8, "head_dim": 128, "steps": 5,
         "dtypes": "float32,bfloat16"}
WEIGHTS = ("wq", "wk", "wv", "wo")
SEED = 0            # the JAX script's numpy seed
# SGD step: the JAX script's 0.1 in f32.  bf16 projections round the f32
# master weights to bf16 (2^-11 at |w| ~ D^-1/2), and an update of
# 0.1 x grad (~3e-6 at the card's width) would leave nearly all of them
# unchanged, so the bf16 run steps 100x further (~one bf16 ulp of a
# weight)
LR = {"float32": 0.1, "bfloat16": 10.0}


def block(params, xd: torch.Tensor, pen, dtype=torch.float32,
          impl: str = "auto") -> torch.Tensor:
    """One causal attention block on this rank's raw zigzag-placed
    ``(S/P, H, D)`` block: local projections (no collectives), the
    zigzag ring, the output projection.  The weights are float32
    masters; with ``dtype`` bfloat16, x and the weights are cast for
    the projections, so q/k/v, the attention and its output are
    bfloat16."""
    D = xd.shape[-1]
    xc = xd.to(dtype)

    def proj(w):
        return pat.PencilArray(pen, xc @ params[w].to(dtype), (D,))

    out = ring_attention(proj("wq"), proj("wk"), proj("wv"), causal=True,
                         zigzag=True, impl=impl)
    return out.data @ params["wo"].to(dtype)


def loss_and_grads(params, xd: torch.Tensor, td: torch.Tensor, pen,
                   dtype=torch.float32, impl: str = "auto"):
    """The mean squared error of the block against ``td`` over the
    global (S, H, D) array, in float32, and the gradients of every
    weight summed over the ranks (each holds a replica)."""
    y = block(params, xd, pen, dtype, impl).float()
    loss = pat.ops.mean(pat.PencilArray(pen, (y - td) ** 2, (xd.shape[-1],)))
    grads = torch.autograd.grad(loss, [params[w] for w in WEIGHTS])
    topo = pen.topology
    if topo.connected and len(topo) > 1:
        for g in grads:
            dist.all_reduce(g, group=topo.group)
    return float(loss.detach()), dict(zip(WEIGHTS, grads))


def sgd(params, grads, lr: float) -> None:
    """One descent step on the float32 masters, in place."""
    with torch.no_grad():
        for w in WEIGHTS:
            params[w] -= lr * grads[w]


def run(device=None, seq=SIZES["seq"], heads=SIZES["heads"],
        head_dim=SIZES["head_dim"], steps=SIZES["steps"],
        dtypes=SIZES["dtypes"]) -> dict:
    """``steps`` SGD steps from the JAX script's inputs (its numpy seed
    and draw order), per dtype of ``dtypes`` (names joined by commas)."""
    P = pat.distributed.process_count()
    S, H, D = int(seq), int(heads), int(head_dim)
    topo = pat.Topology((P,), device=device)
    pen = pat.Pencil(topo, (S, H), (0,))
    rng = np.random.default_rng(SEED)
    x, target = (to_zigzag(pat.PencilArray.from_global(
        pen, rng.standard_normal((S, H, D)).astype(np.float32),
        extra_ndims=1)).data for _ in range(2))
    init = {w: (rng.standard_normal((D, D)) / np.sqrt(D)).astype(np.float32)
            for w in WEIGHTS}
    out = {"seq": S, "heads": H, "head_dim": D, "ranks": P}
    for name in dtypes.split(","):
        dtype = getattr(torch, name)
        params = {w: torch.from_numpy(a).to(topo.device).requires_grad_()
                  for w, a in init.items()}
        losses = []
        for _ in range(steps):
            loss, grads = loss_and_grads(params, x, target, pen, dtype)
            sgd(params, grads, LR[name])
            losses.append(loss)
        if not (all(math.isfinite(v) for v in losses)
                and losses[-1] < losses[0]):
            raise AssertionError(f"training {name}: the loss did not "
                                 f"fall: {losses}")
        out[f"losses_{name}"] = losses
        out[f"weights_{name}"] = {w: p.detach().cpu().numpy()
                                  for w, p in params.items()}
    return out


def main(argv=None) -> int:
    return _launch.main(__spec__.name, __doc__, SIZES, argv)


if __name__ == "__main__":
    raise SystemExit(main())
