"""Plain PyTorch references, one module per driver kind.  They import
nothing of the program: each works out again the wavenumbers, masks,
factors and memory orders the program derives."""

from typing import Optional

import torch


def rounder(round_to: Optional[torch.dtype]):
    """Rounds a tensor to ``round_to`` and back (the check's control,
    which stands for the program storing its fields in that dtype);
    ``None`` leaves it as it is."""
    if round_to is None:
        return lambda t: t

    def rnd(t: torch.Tensor) -> torch.Tensor:
        if t.is_complex():
            r = torch.view_as_real(t)
            return torch.view_as_complex(r.to(round_to).to(r.dtype)
                                         .contiguous())
        return t.to(round_to).to(t.dtype)
    return rnd
