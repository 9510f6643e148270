"""What the kernel metrics share: their inputs' generator, the Poisson
weights, and the timing of a kernel alone by CUDA events."""

from __future__ import annotations

import statistics

import torch

# launches a batch, and batches: the median batch's time a launch
LAUNCHES = 50
BATCHES = 5


def generator(run) -> torch.Generator:
    g = torch.Generator(device=run.device)
    g.manual_seed(int(run.seed) % (1 << 63))
    return g


def poisson5_w33(side: int) -> tuple:
    """The 3 x 3 weights of grid.hpp's 5-point Laplacian at ``side``."""
    h2 = (2.0 / (side + 1)) ** 2
    return ((0.0, 1.0 / h2, 0.0), (1.0 / h2, -4.0 / h2, 1.0 / h2),
            (0.0, 1.0 / h2, 0.0))


def time_launches(fn, device) -> float:
    """Seconds a launch of ``fn``: warm launches first, then BATCHES
    batches of LAUNCHES between two CUDA events each, the median."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(BATCHES):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(LAUNCHES):
            fn()
        stop.record()
        torch.cuda.synchronize(device)
        times.append(start.elapsed_time(stop) * 1e-3 / LAUNCHES)
    return statistics.median(times)
