"""The x -> y -> z -> y -> x transpose cycle of a seeded array.

Each step runs the cycle's hops through ``pencilarrays_tpu_torch.
transpose`` with the cell's method, from the same input; the window keeps
the last step's hop outputs, and the check counts the elements of each
whose bits differ from the reference's permutation of the input.  The
control moves every hop through a bfloat16 wire.
"""

from __future__ import annotations

import torch

import pencilarrays_tpu_torch as pat

from .. import fields
from ..compare import mismatched
from ..reference import transpose_cycle as ref

METHODS = {"AllToAll": pat.AllToAll, "Ring": pat.Ring}


class Cell:
    def __init__(self, config, params, seed, device, control=False):
        self.device = torch.device(device)
        shape = tuple(config["grid"])
        topo = pat.Topology(tuple(config["process_grid"]), device=device)
        specs = config["pencils"]
        self.orders = [specs[p]["order"] for p in config["cycle"]]
        pencils = [pat.Pencil(topo, shape, tuple(specs[p]["decomp"]),
                              permutation=pat.Permutation(*specs[p]["order"]))
                   for p in config["cycle"]]
        self.chain = pencils[1:]
        self.method = METHODS[params["method"]](
            wire_dtype="bf16" if control else None)
        gen = fields.generator(seed, self.device)
        mem_shape = [shape[d] for d in self.orders[0]]
        self.x = pat.PencilArray(pencils[0], torch.randn(
            mem_shape, generator=gen, device=self.device,
            dtype=getattr(torch, config["dtype"])))
        # each hop reads and writes the whole array once
        self.transpose_bytes = (2 * len(self.chain) * self.x.data.numel()
                                * self.x.data.element_size())
        self.outs = None

    def warmup(self):
        self.step()
        self.step()

    def step(self):
        self.outs = None
        v, outs = self.x, []
        for pen in self.chain:
            v = pat.transpose(v, pen, method=self.method)
            outs.append(v)
        self.outs = outs

    def release(self):
        self.method = None

    def check(self):
        bad = 0
        for out, order in zip(self.outs, self.orders[1:]):
            bad += mismatched(out.data, ref.expected(self.x.data,
                                                     self.orders[0], order))
        return {"mismatched_elements": float(bad)}


def setup(config, params, seed, device, control=False):
    return Cell(config, params, seed, device, control)
