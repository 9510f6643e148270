"""The device loops' cond/body form against JAX (CPU): part (a) of
tests/test_torch_device_loop.py (``check_against_jax``) for the unpacked
df32 and f64 loops. A file of its own: each case compiles a JAX solver
(~25 s), and the test workers take whole files.
"""

import pytest
import torch

from test_torch_device_loop import SOLVES, check_against_jax

torch.set_num_threads(1)

UNPACKED = [c for c in SOLVES if c[7] != "packed"]


@pytest.mark.parametrize("case", UNPACKED, ids=[c[0] for c in UNPACKED])
def test_loop_matches_jax(case):
    check_against_jax(case)
