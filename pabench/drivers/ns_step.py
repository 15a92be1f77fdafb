"""Steady RK2 stepping of ``NavierStokesSpectral`` from a seeded flow.

The window calls ``model.step`` back to back, each step on the state the
last one returned.  Set-up steps twice from the seeded state (the first
step's input and output go to the host for the check); the window goes on
from there.  The check runs the reference's step, in float64, from the
seeded state and from the state before the window's last step, and holds
the program's first and last steps to them.  The second check follows the
program from its own state: the reference alone cannot replay a window of
a hundred steps in less time than the window.
"""

from __future__ import annotations

import torch

import pencilarrays_tpu_torch as pat
from pencilarrays_tpu_torch.models import NavierStokesSpectral

from .. import fields
from ..compare import max_rel_err
from ..reference import ns_step as ref


class Cell:
    transpose_bytes = None

    def __init__(self, config, params, seed, device, control=False):
        self.device = torch.device(device)
        self.shape = tuple(config["grid"])
        self.order = config["layout"]["spectral"]
        self.nu = float(config["viscosity"])
        self.dt = float(config["dt"])
        self.dealias = bool(config["dealias"])
        topo = pat.Topology(tuple(config["process_grid"]), device=device)
        self.model = NavierStokesSpectral(
            topo, self.shape, viscosity=self.nu,
            dtype=getattr(torch, config["dtype"]), dealias=self.dealias)
        self.pen = self.model.plan.output_pencil
        gen = fields.generator(seed, self.device)
        u0 = fields.solenoidal_spectrum(self.shape, gen, **params["init"])
        self.state = pat.PencilArray(self.pen,
                                     fields.to_memory(u0, self.order), (3,))
        del u0
        self.prev = None
        self.stepper = self._control_step if control else self.model.step
        if control:
            self._ops = ref.Operators(self.shape, self.device, torch.float32,
                                      self.dealias)

    def _control_step(self, uh, dt):
        """The reference in the program's place, every stored field
        rounded to bfloat16."""
        r = fields.from_memory(uh.data, self.order)
        out = ref.step(r, self._ops, self.nu, dt, round_to=torch.bfloat16)
        return pat.PencilArray(self.pen, fields.to_memory(out, self.order),
                               (3,))

    def warmup(self):
        s1 = self.stepper(self.state, self.dt)
        self.u0_host = self.state.data.cpu()
        self.state = None
        s2 = self.stepper(s1, self.dt)
        self.s1_host = s1.data.cpu()
        self.state = s2

    def step(self):
        self.prev = self.state
        self.state = self.stepper(self.state, self.dt)

    def release(self):
        self.model = self.stepper = None

    def _ref_step(self, mem):
        ops = ref.Operators(self.shape, self.device, torch.float64,
                            self.dealias)
        r = fields.from_memory(mem.to(self.device), self.order)
        return ref.step(r.to(torch.complex128), ops, self.nu, self.dt)

    def check(self):
        got = fields.from_memory(self.s1_host.to(self.device), self.order)
        first = max_rel_err(got, self._ref_step(self.u0_host))
        self.u0_host = self.s1_host = got = None
        want = self._ref_step(self.prev.data)
        self.prev = None
        last = max_rel_err(fields.from_memory(self.state.data, self.order),
                           want)
        return {"first_step_err": first, "last_step_err": last}


def setup(config, params, seed, device, control=False):
    return Cell(config, params, seed, device, control)
