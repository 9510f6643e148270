"""The yardstick of the kernel metrics: the card's peaks, and each
kernel's operations and bytes worked out from its shapes.

Bytes count each input read once and each output written once, whatever
the kernel reads again; operations count what the algorithm needs for
the call. The least time is the larger of bytes over the memory's rate
and operations over the f32 rate, at the data sheet's peaks.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the full 700 W
# (an H100 80GB HBM3); a card is matched by the part of its name given
PEAKS = {
    "H100": {"hbm_bytes_per_s": 3.35e12, "f32_ops_per_s": 67e12},
}
F32 = 4

# 5-point operators: four off-diagonal neighbours a cell
NEIGHBOURS = 4


def sweep_ops(cells: int, neighbours: int = NEIGHBOURS,
              symmetric: bool = True) -> int:
    """One four-colour Gauss-Seidel sweep: a multiply and an add a
    neighbour, then b - acc, * 1/diag, - u, * omega, + u; each cell twice
    when the sweep is symmetric."""
    return cells * (2 if symmetric else 1) * (2 * neighbours + 5)


def residual_ops(cells: int, neighbours: int = NEIGHBOURS) -> int:
    """b - A u: a multiply and an add a neighbour, the centre's product,
    its add, and the subtraction."""
    return cells * (2 * neighbours + 3)


def down_leg(M: int) -> tuple[int, int]:
    """(bytes, operations) of K2 (``fused_down_leg_packed``) on packed
    (4, M, M) f32 fields: u and b read, the smoothed u and the (M, M)
    padded coarse rhs written; a symmetric sweep, the residual and the
    full-weighting restriction (9 products and 8 adds a coarse cell)."""
    cells = 4 * M * M
    nbytes = (cells + cells + cells + M * M) * F32
    ops = sweep_ops(cells) + residual_ops(cells) + 17 * M * M
    return nbytes, ops


def residual_restrict(M: int) -> tuple[int, int]:
    """(bytes, operations) of K8 (``fused_residual_restrict_packed``) on
    packed (4, M, M) f32 fields: u and b read, the (M, M) padded coarse
    rhs written; the residual and the full-weighting restriction."""
    cells = 4 * M * M
    nbytes = (cells + cells + M * M) * F32
    return nbytes, residual_ops(cells) + 17 * M * M


def least_seconds(kind: str, nbytes: int, ops: int) -> tuple[float, str]:
    """(the least seconds on card ``kind``, "bytes" or "operations")."""
    found = [v for k, v in PEAKS.items() if k in kind]
    if not found:
        raise KeyError(f"no peaks for the card {kind!r}")
    p = found[0]
    t_bytes = nbytes / p["hbm_bytes_per_s"]
    t_ops = ops / p["f32_ops_per_s"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
