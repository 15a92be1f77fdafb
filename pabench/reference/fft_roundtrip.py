"""Plain 3-D real-to-complex transform and its inverse, unnormalized
forward and normalized backward (the program's ``normalization=
"backward"``), over ``(C, X, Y, Z)`` fields.  ``round_to`` rounds the
input and each output to a narrower float (the check's control)."""

from __future__ import annotations

from typing import Optional

import torch

from ..fields import irfft3, rfft3
from . import rounder


def forward(u: torch.Tensor, round_to: Optional[torch.dtype] = None):
    rnd = rounder(round_to)
    return rnd(rfft3(rnd(u)))


def backward(uh: torch.Tensor, nx: int,
             round_to: Optional[torch.dtype] = None):
    rnd = rounder(round_to)
    return rnd(irfft3(rnd(uh), nx))
