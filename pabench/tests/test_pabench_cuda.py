"""On the card: every cell at a small size passes its check, and its
bfloat16 control fails it (the control at each cell's own size is read by
``pabench/readings.py --control``).  Run from the checkout's root on a
machine with a card::

    python -m pytest --noconftest -m cuda pabench/tests/test_pabench_cuda.py
"""

import time

import pytest
import torch

from pabench import harness

CELLS = ["ns512.rk2", "ns512.fft_rt", "cycle1024.alltoall", "cycle1024.ring"]
SMALL = {"ns512_f32": [64, 48, 40], "pencil1024_f32": [96, 80, 64]}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card_passes_and_its_control_fails(card, name):
    wl, cfg = harness.find_cell(name)
    cfg = dict(cfg, grid=SMALL[cfg["name"]])
    good = harness.run_cell(wl, cfg, 2**31 + 5, 0.5, True, card,
                            time.perf_counter())
    assert good["correct"] is True, good["checks"]
    assert good["device"]["busy_s"] > 0
    bad = harness.run_cell(wl, cfg, 2**31 + 5, 0.5, False, card,
                           time.perf_counter(), control=True)
    assert bad["correct"] is False, bad["checks"]
