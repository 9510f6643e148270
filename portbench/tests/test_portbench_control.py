"""The comparison's control, on the card: the program's own f32 path in
its place (``Driver.control``) fails the configuration's rss rule, while
the program's own answers pass it, at a side a test run holds (the
benchmark's readings at the cells' own size: ``portbench/control.py``).
Skips without a card."""

import pytest
import torch

from portbench import control

SIDE = 2047
SEEDS = [2**31 + 1, 2**31 + 2, 2**31 + 3]


@pytest.mark.cuda
def test_control_fails_and_program_passes(cuda):
    out = control.readings("poisson4095.sweep", SEEDS[:1], SEEDS, 20, cuda,
                           overrides={"side": SIDE})
    assert out["lower"] <= out["tolerance"] < out["upper"], out
    torch.cuda.synchronize()
