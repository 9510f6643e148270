"""Driver of ``amg_tpu_torch.DistStructuredSolver`` across the processes of
a ``torch.distributed`` group through its user entry point
``solve_ir_fused``: collective (every rank calls it in the same order),
one CUDA graph launch a solve a block on the card, then one read of the
stats and the field gathered to every rank.

Config keys (``solver``): ``side``, ``options`` (keyword arguments of the
constructor: ``n_devices`` the slabs, ``halo``), ``tolerance``,
``n_refine``."""

from __future__ import annotations

import torch

from amg_tpu_torch import DistStructuredSolver

# solve_ir_fused returns with its stats on the host: one solve in flight
MAX_IN_FLIGHT = 1


class Driver:
    def __init__(self, solver: dict, inputs: dict, device):
        if inputs.get("planes") is not None:
            raise ValueError("the distributed driver takes the Poisson "
                             "operator only")
        self.tolerance = float(solver["tolerance"])
        self.n_refine = int(solver["n_refine"])
        self.solver = DistStructuredSolver(
            int(solver["side"]), device=device, **solver.get("options", {}))
        self.cycles_per_refine = self.solver.cycles_per_refine

    def warmup(self) -> None:
        """Capture and instantiate every program's graph (collective)."""
        self.solver.warmup()

    def submit(self, b: torch.Tensor):
        return self.solver.solve_ir_fused(b, self.tolerance, self.n_refine)

    def read(self, res) -> tuple:
        """``(u, rss, refines)``: the f64 field on this rank, and the
        stats as ``solve_ir_fused`` read them."""
        return res.u, res.error, res.iterations / self.cycles_per_refine

    def control(self, b: torch.Tensor, cycles: int) -> torch.Tensor:
        """The program's own f32 path of the same solver (``solve``: f32
        V-cycles and their rss, the reference's outer loop), ``cycles``
        V-cycles at most (collective): the comparison's control."""
        res = self.solver.solve(b, self.tolerance, 5, cycles)
        return res.u.to(torch.float64)

    def close(self) -> None:
        """Release the peer memory (collective)."""
        if self.solver is not None:
            self.solver.close()
            self.solver = None
