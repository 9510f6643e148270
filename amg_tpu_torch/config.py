"""Configuration dataclasses.

PyTorch port of ``amg_tpu/config.py:17-73``, with JAX's defaults field for
field. The reference has no config system: its knobs are constructor
arguments with fixed defaults (multigrid.hpp:155-156: tol 1e-9,
check-every 10, 100 iterations; smoother.hpp:25-37: tol 1e-9, check-every
100, 1 iteration). ``StructuredConfig.dtype`` is ``torch.float32``.

Each solver reads its config by its JAX counterpart's rule:
``Multigrid`` lets a SolverConfig override its arguments;
``StructuredSolver`` and ``DistStructuredSolver`` take an explicit
argument first, then the config, then the default.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SmootherConfig:
    """SmootherBase's hyperparameters (smoother.hpp:25-37)."""

    tolerance: float = 1e-9
    compute_error_every_n_iters: int = 100
    n_iters: int = 1
    omega: float = 1.0
    symmetric: bool = True


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """The Multigrid ctor defaults (multigrid.hpp:155-156)."""

    n_levels: int = 8
    tolerance: float = 1e-9
    compute_error_every_n_iters: int = 10
    n_iters: int = 100


@dataclasses.dataclass(frozen=True)
class StructuredConfig:
    """Structured-path knobs (structured.py)."""

    dtype: object = torch.float32
    pre_sweeps: int = 1
    post_sweeps: int = 1
    omega: float = 1.0
    symmetric: bool = True
    refine_tolerance: float = 1e-9
    cycles_per_refine: int = 3
    # 'auto' | 'packed' | 'masked' | 'fused' | 'chebyshev' | 'strided'
    smoother: str = "auto"
    packed_min_side: int | None = None  # None -> structured.PACKED_MIN_SIDE


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Distribution knobs (parallel/structured_dist.py)."""

    # slabs; None: one a visible card. With the solvers' device None the
    # slabs spread over the cards (a card group, parallel/launch.py
    # slab_devices), as JAX's mesh over all local devices
    n_devices: int | None = None
    axis_name: str = "x"
    min_rows_per_device: int = 2   # agglomeration threshold
    # None: 'overlap' on the card, 'step' on the CPU | 'overlap' | 'sweep'
    # | 'rdma' | 'step'
    halo: str | None = None
    # V-cycles per df32 defect-correction step; None: the solver's default
    cycles_per_refine: int | None = None
