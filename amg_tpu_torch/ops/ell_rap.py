"""Galerkin RAP of ELL operators on the device (the general path).

PyTorch port of ``amg_tpu/ops/ell_rap.py:36-163``. The reference computes
``A_H = R (A P)`` with two host SpGEMMs (multigrid.hpp:219-223). Under its
transfer structure (interpolator.hpp:98-142: P[2b + d, b] = w_d with
w = (1/2, 1, 1/2) and R = P^T) the product has a closed form over the fine
entries:

    A_H[a, b] = sum_{d1, d2 in {0,1,2}} w_{d1} w_{d2} A[2a + d1, 2b + d2]

It is split into a symbolic phase (``EllRapPlan.build``, numpy on the
host, once per sparsity pattern: every contribution of every fine slot
gets its coarse output slot) and a numeric phase (``apply``, on the
device). A hierarchy then takes new operator values with no host SpGEMM
(``multigrid.rebuild_hierarchy_values``, BASELINE config 4).

JAX's numeric phase is a scatter-add. Several contributions land in one
output slot, and on the card a scatter-add's order is not fixed, so
``apply`` instead gathers each output slot's contributions, ascending in
the contribution index 0..6K-1 and padded with zeros to a fixed count,
and adds them left to right: the same sum on the CPU and the card, every
run, in the order of JAX's scatter on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from amg_tpu_torch.sparse.ell import ELL

_W = (0.5, 1.0, 0.5)


def _expand_cols(cols: np.ndarray, vals_mask: np.ndarray, n_H: int):
    """Each fine slot's column c feeds coarse columns b with c = 2b + d2:
    two (c even: d2 in {0, 2}) or one (c odd: d2 = 1). Returns (b, w, ok),
    each of shape cols.shape + (2,)."""
    c = cols.astype(np.int64)
    even = c % 2 == 0
    b = np.stack([np.where(even, c // 2, (c - 1) // 2),
                  np.where(even, c // 2 - 1, -1)], axis=-1)
    w = np.stack([np.where(even, 0.5, 1.0),
                  np.where(even, 0.5, 0.0)], axis=-1)
    ok = (b >= 0) & (b < n_H) & (w != 0.0) & vals_mask[..., None]
    return b, w, ok


def _slot_gather(order, slot_sorted, new_run, valid_sorted, K_out: int):
    """(n_H, K_out * M) indices into a row's 6K contributions plus one zero
    column (index 6K): output slot s of row r sums entries
    [s*M:(s+1)*M], the contributions assigned to s in ascending index
    (each row's stable sort by column lists them so, one run a slot),
    then the zero column."""
    n_H, C = order.shape
    pos = np.arange(C)
    run_start = np.maximum.accumulate(np.where(new_run, pos, 0), axis=1)
    in_run = pos - run_start                     # position within the run
    M = int(np.where(valid_sorted, in_run, 0).max(initial=0)) + 1
    # flat target of each sorted entry; the invalid ones go to one spare
    # slot past the end
    size = n_H * K_out * M
    target = np.where(valid_sorted, (np.arange(n_H)[:, None] * K_out
                                     + slot_sorted) * M + in_run, size)
    gather = np.full(size + 1, C, dtype=np.int64)
    gather[target] = order
    return gather[:size].reshape(n_H, K_out * M)


@dataclasses.dataclass(frozen=True)
class EllRapPlan:
    """Symbolic structure of one Galerkin RAP level.

    assign:   (n_H, 6K) output slot of each expanded contribution (K_out:
              dropped or padding), JAX's array.
    out_cols: (n_H, K_out) coarse ELL column pattern.
    weights:  (n_H, 6K) w_{d1} w_{d2} of each contribution (0 if dropped).
    gather:   (n_H, K_out * M) each output slot's contributions, M a slot,
              in ascending order, padded with the zero column 6K.
    """

    assign: torch.Tensor
    out_cols: torch.Tensor
    weights: torch.Tensor
    gather: torch.Tensor
    n_h: int
    n_H: int
    K: int
    K_out: int
    M: int

    @staticmethod
    def build(A_cols: np.ndarray, pad_mask: np.ndarray, n_h: int, n_H: int,
              dtype=torch.float64, device="cpu") -> "EllRapPlan":
        """Symbolic phase (host numpy, once per pattern). A_cols: (n_h, K)
        fine ELL columns; pad_mask True on real (non-padding) slots."""
        K = A_cols.shape[1]
        b2, w2, ok2 = _expand_cols(A_cols, pad_mask, n_H)  # (n_h, K, 2)
        a = np.arange(n_H)
        rows3 = np.stack([2 * a, 2 * a + 1, 2 * a + 2], axis=1)  # (n_H, 3)
        if n_H and rows3.max() >= n_h:
            raise ValueError(f"coarse size {n_H} too large for {n_h} rows")
        gb = b2[rows3].reshape(n_H, 6 * K)
        gw = w2[rows3] * np.asarray(_W)[None, :, None, None]
        gok = ok2[rows3]
        gw = np.where(gok, gw, 0.0).reshape(n_H, 6 * K)
        gok = gok.reshape(n_H, 6 * K)
        # output slots: sort each row's contributions by column, number the
        # runs of equal columns, map back to contribution order
        BIG = n_H + 1
        key = np.where(gok, gb, BIG)
        order = np.argsort(key, axis=1, kind="stable")
        sc = np.take_along_axis(key, order, axis=1)
        new_run = np.ones_like(sc, dtype=bool)
        new_run[:, 1:] = sc[:, 1:] != sc[:, :-1]
        new_run &= sc < BIG
        slot_sorted = np.cumsum(new_run, axis=1) - 1
        n_runs = new_run.sum(axis=1)
        K_out = max(int(n_runs.max()) if n_H else 0, 1)
        assign = np.full((n_H, 6 * K), K_out, dtype=np.int64)
        rr = np.broadcast_to(np.arange(n_H)[:, None], order.shape)
        valid_sorted = (sc < BIG) & (slot_sorted >= 0)
        assign[rr[valid_sorted], order[valid_sorted]] = \
            slot_sorted[valid_sorted]
        out_cols = np.tile(np.minimum(np.arange(n_H), max(n_H - 1, 0)
                                      )[:, None], (1, K_out))
        starts = new_run & (slot_sorted >= 0)
        out_cols[rr[starts], slot_sorted[starts]] = sc[starts]
        gather = _slot_gather(order, slot_sorted, new_run, valid_sorted,
                              K_out)

        def dev(x, dt=None):
            return torch.from_numpy(np.ascontiguousarray(x)).to(
                device=device, dtype=dt)

        return EllRapPlan(assign=dev(assign), out_cols=dev(out_cols),
                          weights=dev(gw, dtype), gather=dev(gather),
                          n_h=n_h, n_H=n_H, K=K, K_out=K_out,
                          M=gather.shape[1] // K_out)

    def apply(self, A_data: torch.Tensor) -> ELL:
        """Numeric phase: fine ELL values (n_h, K) in the plan's pattern ->
        the coarse ELL."""
        n_H, K, K_out = self.n_H, self.K, self.K_out
        gv = torch.stack([A_data[0:2 * n_H:2], A_data[1:2 * n_H + 1:2],
                          A_data[2:2 * n_H + 2:2]], dim=1).reshape(n_H, 3 * K)
        gv = torch.repeat_interleave(gv, 2, dim=1) * self.weights  # (n_H, 6K)
        g = F.pad(gv, (0, 1)).gather(1, self.gather).reshape(n_H, K_out,
                                                             self.M)
        out = g[..., 0]
        for m in range(1, self.M):
            out = out + g[..., m]
        return ELL(data=out, cols=self.out_cols, shape=(n_H, n_H))


def build_rap_plans(A: ELL, n_levels: int):
    """Plans for levels 1..n_levels-1 (each coarse pattern feeds the next
    plan); returns (plans, level_mats) with level_mats[0] = A."""
    plans = []
    mats = [A]
    for _ in range(n_levels - 1):
        cur = mats[-1]
        n_h = cur.n_rows
        n_H = (n_h + 1) // 2 - 1  # multigrid.hpp:127-130
        plan = EllRapPlan.build(cur.cols.cpu().numpy(),
                                cur.data.cpu().numpy() != 0, n_h, n_H,
                                dtype=cur.dtype, device=cur.device)
        plans.append(plan)
        mats.append(plan.apply(cur.data))
    return plans, mats


def apply_rap_chain(plans, A_data: torch.Tensor) -> tuple:
    """New fine values -> every level's values, on the device (the
    SpGEMM-free form of multigrid.hpp:211-223 for repeated setups)."""
    datas = [A_data]
    for plan in plans:
        datas.append(plan.apply(datas[-1]).data)
    return tuple(datas)
