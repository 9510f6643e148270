"""K10 and K11: the masked V-cycle of the coarse levels as two one-block
kernels (``csrc/masked_cycle.cu``), the down leg and the up leg, with the
coarsest level's direct solve between them (the caller's).

The port's own kernels: they replace no TPU kernel. JAX runs these levels
as plain ``jnp`` ops (``amg_tpu/structured.py`` ``cycle_stencil``), and so
does the port's plain path, one PyTorch kernel an op: about 475 a level.

* :func:`masked_down_leg` (K10): from the entry level l0 down to the
  coarsest but one, on each level ``sweeps`` masked four-color sweeps, the
  residual and the restriction P1^T r P1 into the next level's b (whose u
  starts at 0). Returns the coarsest level's b and the workspace: each
  level's smoothed u and each b below l0, which K11 reads.
* :func:`masked_up_leg` (K11): from the coarsest level's solution back up,
  on each level u += P1 uc P1^T and ``sweeps`` sweeps. Returns level l0's u.

The plain twins (:func:`masked_down_leg_plain`, :func:`masked_up_leg_plain`)
are the existing ops (``gs4_sweep_masked``, ``matvec2``, the two GEMMs of
``restrict_mm`` / ``prolong_mm`` with the bilinear P1 that every hierarchy
of the port holds), with the same workspace. On the card the kernels give
their bits: the same arithmetic, the GEMMs' sums in cuBLAS's order.

:func:`fits` is the shared-memory rule: a cycle entered at side n needs
``smem_bytes(n)`` of one block's 232,448 bytes, so on 2^k - 1 hierarchies
the entry is at most 127^2.
"""

from __future__ import annotations

import ctypes

import torch

from amg_tpu_torch.ops.kernels._build import (check, count_launch, library,
                                              require_f32, stream_of)
from amg_tpu_torch.ops.rap import interp1d_dense
from amg_tpu_torch.sparse.stencil import (Stencil2D, color_masks_iota,
                                          gs4_sweep_masked)

MAX_LEVELS = 8            # csrc/masked_cycle.cu kMaxLevels
SMEM_LIMIT = 232448       # shared memory one block may use on the H100


class MaskedCall(ctypes.Structure):
    """csrc/masked_cycle.cu MaskedCall, field for field."""

    _fields_ = [("u", ctypes.c_void_p), ("b", ctypes.c_void_p),
                ("uc", ctypes.c_void_p), ("ws", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("stream", ctypes.c_void_p),
                ("side", ctypes.c_int), ("levels", ctypes.c_int),
                ("sweeps", ctypes.c_int), ("symmetric", ctypes.c_int),
                ("omega", ctypes.c_float),
                ("w", (ctypes.c_float * 9) * MAX_LEVELS),
                ("inv_diag", ctypes.c_float * MAX_LEVELS)]


def smem_bytes(side: int) -> int:
    """Shared memory of a cycle entered at ``side``: u and b in the padded
    packed layout, 2 x 4 (M+1)^2 floats, and the transfers' scratch,
    side x (side-1)/2 floats."""
    p = (side + 1) // 2 + 1
    return 4 * (8 * p * p + side * ((side - 1) // 2))


def sides_of(side: int, levels: int) -> list:
    """The sides of the ``levels`` smoothed levels and of the coarsest."""
    sides = [side]
    for _ in range(levels):
        sides.append((sides[-1] - 1) // 2)
    return sides


def fits(side: int, levels: int) -> bool:
    """Whether K10/K11 take a cycle entered at ``side`` over ``levels``
    smoothed levels: the shared memory, the level count, odd sides of at
    least 3 on every smoothed level."""
    sides = sides_of(side, levels)[:-1]
    return (1 <= levels <= MAX_LEVELS and smem_bytes(side) <= SMEM_LIMIT
            and all(n >= 3 and n % 2 == 1 for n in sides))


def workspace_floats(side: int, levels: int) -> int:
    """The workspace: level l0's u, then each lower smoothed level's u and
    b."""
    sides = sides_of(side, levels)[:-1]
    return sides[0] ** 2 + sum(2 * n * n for n in sides[1:])


def _restrict(r2):
    n = r2.shape[0]
    P1 = interp1d_dense(n, (n - 1) // 2, r2.dtype, r2.device)
    return P1.T @ r2 @ P1


def _prolong(uc2, n: int):
    P1 = interp1d_dense(n, uc2.shape[0], uc2.dtype, uc2.device)
    return P1 @ uc2 @ P1.T


def _sweeps(w33, u2, b2, sweeps: int, omega: float, symmetric: bool):
    n = u2.shape[0]
    S = Stencil2D.const(w33, n, u2.dtype)
    masks = color_masks_iota(n, u2.dtype, u2.device)
    for _ in range(sweeps):
        u2 = gs4_sweep_masked(S, u2, b2, masks, omega, symmetric)
    return S, u2


def masked_down_leg_plain(u2, b2, w33s, sweeps: int = 1, omega: float = 1.0,
                          symmetric: bool = True):
    """K10's plain twin: ``(bc, ws)``, the coarsest level's b and the
    workspace."""
    parts = []
    for k, w33 in enumerate(w33s):
        S, u2 = _sweeps(w33, u2, b2, sweeps, omega, symmetric)
        parts += [u2, b2] if k else [u2]
        bc = _restrict(b2 - S.matvec2(u2))
        u2, b2 = torch.zeros_like(bc), bc
    return b2, torch.cat([p.reshape(-1) for p in parts])


def masked_up_leg_plain(uc, b2, ws, w33s, sweeps: int = 1,
                        omega: float = 1.0, symmetric: bool = True):
    """K11's plain twin: level l0's u after the cycle."""
    sides = sides_of(b2.shape[0], len(w33s))
    offs = [0]
    for k, n in enumerate(sides[:-1]):
        offs.append(offs[-1] + (2 if k else 1) * n * n)
    for k in range(len(w33s) - 1, -1, -1):
        n = sides[k]
        u2 = ws[offs[k]:offs[k] + n * n].reshape(n, n)
        bk = b2 if k == 0 else ws[offs[k] + n * n:offs[k + 1]].reshape(n, n)
        u2 = u2 + _prolong(uc, n)
        _, uc = _sweeps(w33s[k], u2, bk, sweeps, omega, symmetric)
    return uc


def _checked(name: str, u2, b2, w33s) -> tuple:
    n = b2.shape[0]
    levels = len(w33s)
    require_f32("b2", b2, (n, n), b2.device)
    if u2 is not None:
        require_f32("u2", u2, (n, n), b2.device)
    if not fits(n, levels):
        raise ValueError(f"{name}: a cycle entered at {n}^2 over {levels} "
                         f"levels does not fit one block")
    if any(w is None for w in w33s):
        raise ValueError(f"{name}: every level needs constant weights")
    return n, levels


def _call(u2, b2, uc, ws, out, w33s, sweeps: int, omega: float,
          symmetric: bool) -> MaskedCall:
    call = MaskedCall(
        u=0 if u2 is None else u2.data_ptr(), b=b2.data_ptr(),
        uc=0 if uc is None else uc.data_ptr(), ws=ws.data_ptr(),
        out=out.data_ptr(), stream=stream_of(b2), side=b2.shape[0],
        levels=len(w33s), sweeps=sweeps, symmetric=int(symmetric),
        omega=omega)
    for k, w33 in enumerate(w33s):
        for m, w in enumerate(x for row in w33 for x in row):
            call.w[k][m] = float(w)
        call.inv_diag[k] = 1.0 / w33[1][1]
    return call


def masked_down_leg(u2: torch.Tensor, b2: torch.Tensor, w33s,
                    sweeps: int = 1, omega: float = 1.0,
                    symmetric: bool = True):
    """K10 on contiguous f32 (n, n) fields: the down leg of a masked
    V-cycle entered at n over the levels whose weights ``w33s`` gives (the
    coarsest excluded). Returns ``(bc, ws)``: the coarsest level's b and the
    workspace that :func:`masked_up_leg` reads. CPU tensors take the plain
    twin; CUDA tensors launch K10."""
    n, levels = _checked("masked_down_leg", u2, b2, w33s)
    if b2.device.type == "cpu":
        return masked_down_leg_plain(u2, b2, w33s, sweeps, omega, symmetric)
    nc = sides_of(n, levels)[-1]
    ws = torch.empty(workspace_floats(n, levels), dtype=b2.dtype,
                     device=b2.device)
    bc = torch.empty((nc, nc), dtype=b2.dtype, device=b2.device)
    call = _call(u2, b2, None, ws, bc, w33s, sweeps, omega, symmetric)
    check(library().amg_masked_down_leg(ctypes.addressof(call)),
          "amg_masked_down_leg")
    count_launch(masked_down_leg)
    return bc, ws


def masked_up_leg(uc: torch.Tensor, b2: torch.Tensor, ws: torch.Tensor,
                  w33s, sweeps: int = 1, omega: float = 1.0,
                  symmetric: bool = True) -> torch.Tensor:
    """K11: the up leg from the coarsest level's solution ``uc`` (its (nc,
    nc) field) with K10's workspace ``ws`` and level l0's ``b2``. Returns
    level l0's u. CPU tensors take the plain twin; CUDA tensors launch
    K11."""
    n, levels = _checked("masked_up_leg", None, b2, w33s)
    nc = sides_of(n, levels)[-1]
    require_f32("uc", uc, (nc, nc), b2.device)
    require_f32("ws", ws, (workspace_floats(n, levels),), b2.device)
    if b2.device.type == "cpu":
        return masked_up_leg_plain(uc, b2, ws, w33s, sweeps, omega,
                                   symmetric)
    u_out = torch.empty_like(b2)
    call = _call(None, b2, uc, ws, u_out, w33s, sweeps, omega, symmetric)
    check(library().amg_masked_up_leg(ctypes.addressof(call)),
          "amg_masked_up_leg")
    count_launch(masked_up_leg)
    return u_out


masked_down_leg.launches = 0
masked_up_leg.launches = 0
