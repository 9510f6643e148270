"""The yardstick of K6, the variable-coefficient fused sweep
(``fused_gs4_sweep`` on planes): its bytes and operations worked out from
its shapes, as ``roofline.py`` does for the packed kernels."""

from __future__ import annotations

from portbench import roofline

# the nine f32 planes, u and b read once, u written once
PLANE_SWEEP_WORDS = 9 + 1 + 1 + 1
# off-diagonal neighbours of a 9-point operator
NEIGHBOURS = 8


def var_sweep(n: int) -> tuple[int, int]:
    """(bytes, operations) of one symmetric four-colour sweep of K6 on an
    (n, n) f32 field with (3, 3, n, n) f32 planes: 48 B a cell; a multiply
    and an add a neighbour over 8 neighbours, then the update, each cell
    twice."""
    cells = n * n
    return (cells * PLANE_SWEEP_WORDS * roofline.F32,
            roofline.sweep_ops(cells, NEIGHBOURS))
