"""``plan.forward`` then ``plan.backward`` of the Navier–Stokes model's
own plan (three components a call) on a seeded physical field.

Every step transforms the same input; the window keeps the last step's
spectral and physical outputs, and the check holds them to the
reference's float64 forward transform and round trip of that input.
"""

from __future__ import annotations

import torch

import pencilarrays_tpu_torch as pat
from pencilarrays_tpu_torch.models import NavierStokesSpectral

from .. import fields
from ..compare import max_rel_err
from ..reference import fft_roundtrip as ref


class Cell:
    transpose_bytes = None

    def __init__(self, config, params, seed, device, control=False):
        self.device = torch.device(device)
        self.shape = tuple(config["grid"])
        self.layout = config["layout"]
        topo = pat.Topology(tuple(config["process_grid"]), device=device)
        self.plan = NavierStokesSpectral(
            topo, self.shape, viscosity=float(config["viscosity"]),
            dtype=getattr(torch, config["dtype"]),
            dealias=bool(config["dealias"])).plan
        gen = fields.generator(seed, self.device)
        u = torch.randn((3, *self.shape), generator=gen, device=self.device)
        self.u = pat.PencilArray(
            self.plan.input_pencil,
            fields.to_memory(u, self.layout["physical"]), (3,))
        del u
        self.out = None
        if control:
            self.forward, self.backward = self._control_fwd, self._control_bwd
        else:
            self.forward, self.backward = self.plan.forward, self.plan.backward

    def _control_fwd(self, u):
        """The reference in the program's place, rounded to bfloat16."""
        r = fields.from_memory(u.data, self.layout["physical"])
        out = ref.forward(r, round_to=torch.bfloat16)
        return pat.PencilArray(self.plan.output_pencil, fields.to_memory(
            out, self.layout["spectral"]), (3,))

    def _control_bwd(self, uh):
        r = fields.from_memory(uh.data, self.layout["spectral"])
        out = ref.backward(r, self.shape[0], round_to=torch.bfloat16)
        return pat.PencilArray(self.plan.input_pencil, fields.to_memory(
            out, self.layout["physical"]), (3,))

    def warmup(self):
        self.step()
        self.step()

    def step(self):
        self.out = None
        uh = self.forward(self.u)
        self.out = (uh, self.backward(uh))

    def release(self):
        self.plan = self.forward = self.backward = None

    def check(self):
        u = fields.from_memory(self.u.data, self.layout["physical"])
        uh, back = self.out
        want = ref.forward(u.to(torch.float64))
        fwd = max_rel_err(fields.from_memory(uh.data,
                                             self.layout["spectral"]), want)
        uh = self.out = None
        want = ref.backward(want, self.shape[0])
        rt = max_rel_err(fields.from_memory(back.data,
                                            self.layout["physical"]), want)
        return {"forward_err": fwd, "roundtrip_err": rt}


def setup(config, params, seed, device, control=False):
    return Cell(config, params, seed, device, control)
