"""What each hop of a transpose cycle must hold: the source array's
logical elements in the target pencil's memory order, bit for bit (on one
rank a pencil's block is the whole array)."""

from __future__ import annotations

from typing import Sequence

import torch

from ..fields import logical_view


def expected(src_mem: torch.Tensor, src_order: Sequence[int],
             dst_order: Sequence[int]) -> torch.Tensor:
    """The target pencil's memory-order array, as a view of the source."""
    return logical_view(src_mem, src_order).permute(*dst_order)
