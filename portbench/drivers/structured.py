"""Driver of ``amg_tpu_torch.StructuredSolver`` on one device through its
user entry point ``solve_ir_device``: one CUDA graph launch a solve on the
card, no host synchronisation, so solves pipeline.

Config keys (``solver``): ``side``, ``options`` (keyword arguments of the
constructor), ``tolerance``, ``n_refine``; the operator comes from the
run's inputs (``planes``: the (3, 3, n, n) f32 planes the benchmark made,
or none for the Poisson problem, which the solver builds itself)."""

from __future__ import annotations

import torch

from amg_tpu_torch import StructuredSolver, solve_stencil

# solve_ir_device returns before the work ends and the stats are read
# later, from pinned host slots, one a solve in flight
SLOTS = 16
MAX_IN_FLIGHT = SLOTS - 1


class Driver:
    def __init__(self, solver: dict, inputs: dict, device):
        self.tolerance = float(solver["tolerance"])
        self.n_refine = int(solver["n_refine"])
        self.solver = StructuredSolver(
            int(solver["side"]), A_planes=inputs.get("planes"),
            device=device, **solver.get("options", {}))
        self.cycles_per_refine = self.solver.cycles_per_refine
        pin = self.solver.device.type == "cuda"
        self.slots = [torch.empty(2, dtype=torch.float64, pin_memory=pin)
                      for _ in range(SLOTS)]
        self.issued = 0

    def warmup(self) -> None:
        """Capture and instantiate the solve loop's graphs."""
        self.solver.warmup()

    def submit(self, b: torch.Tensor):
        """Issue one solve, and the copy of its stats [rss, refines] to a
        pinned host slot behind it, with an event after both: no host
        synchronisation. Returns ``(u, slot, event)``."""
        u, stats = self.solver.solve_ir_device(b, self.tolerance,
                                               self.n_refine)
        slot = self.slots[self.issued % SLOTS]
        self.issued += 1
        slot.copy_(stats, non_blocking=True)
        event = None
        if u.is_cuda:
            event = torch.cuda.Event()
            event.record()
        return u, slot, event

    @staticmethod
    def read(pending) -> tuple:
        """``(u, rss, refines)`` of an issued solve: waits for its own
        event only, so later solves in flight keep the card busy."""
        u, slot, event = pending
        if event is not None:
            event.synchronize()
        rss, refines = slot.tolist()
        return u, rss, refines

    def control(self, b: torch.Tensor, cycles: int) -> torch.Tensor:
        """The program's own f32 path on the same hierarchy
        (``solve_stencil``: f32 V-cycles and an f32 rss, JAX's one-shot
        loop), ``cycles`` V-cycles at most: the comparison's control."""
        res = solve_stencil(self.solver.hier, b.to(torch.float32),
                            tolerance=self.tolerance, n_iters=cycles,
                            device=b.device)
        return res.u.to(torch.float64)

    def close(self) -> None:
        self.solver = None
