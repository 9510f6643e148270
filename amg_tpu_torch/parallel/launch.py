"""Processes, the slab mesh, and the one layer every collective of the
distributed solvers goes through.

PyTorch port of ``amg_tpu/parallel/launch.py``. The port's mesh is a
leading slab axis: a field of D row slabs is one (D, B, ...) tensor, and
inside one process every exchange is a tensor op on that axis (a shift,
a window of the padded field, a reshape). Across processes each of P
processes holds D/P consecutive slabs, slab s on process s // (D/P), and
the layer below turns the slab-axis ops into ``torch.distributed`` calls:

* the rows a slab needs from its neighbours (``edges``, ``frame``): the
  strips at the ends of a process's block go to the neighbour ranks by
  send/recv in one batch, as many hops as the strip is deep, through
  host memory under gloo;
* the rss and the inner products (``psum``): ``all_reduce``;
* the agglomeration gather and the gathered field
  (``all_gather_slabs``): ``all_gather``.

The process group is torch.distributed's default group: a process that
has called ``initialize_distributed`` (or ``init_process_group``) with
more than one process runs the distributed solvers across processes;
any other runs them in one process, on the slab axis alone.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist
import torch.nn.functional as F


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> dict:
    """Join the process group: ``coordinator_address`` ("host:port") with
    ``num_processes`` and ``process_id``, else the ``env://`` variables
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK). The backend is "nccl"
    when each process has a card of its own (it takes card
    ``process_id % count``) and "gloo" otherwise. nccl carries card
    tensors only: processes that run the solvers on the CPU hide the cards
    (``CUDA_VISIBLE_DEVICES=""``). Returns JAX's dict, where a device of
    the mesh is a slab, one a process as ``device_mesh_1d(None)`` has it
    (a solver of D slabs holds ``device_mesh_1d(D).slabs_per_process``)."""
    if coordinator_address is not None:
        init = f"tcp://{coordinator_address}"
        world, rank = num_processes, process_id
    else:
        init = "env://"
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    backend = "nccl" if n_cards >= world else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(rank % n_cards)
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank)
    return dict(process_index=process_index(),
                process_count=process_count(),
                local_devices=1, global_devices=process_count())


def process_count() -> int:
    """Processes in the default group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


@dataclasses.dataclass(frozen=True)
class SlabMesh:
    """D row slabs over the processes: process p holds the consecutive
    slabs ``[p * D/P, (p + 1) * D/P)``."""

    n_slabs: int
    axis: str = "x"
    process_count: int = 1
    process_index: int = 0

    def __post_init__(self):
        if self.n_slabs % self.process_count:
            raise ValueError(f"{self.n_slabs} slabs do not split over "
                             f"{self.process_count} processes")

    @property
    def slabs_per_process(self) -> int:
        return self.n_slabs // self.process_count

    @property
    def local_slabs(self) -> range:
        k = self.slabs_per_process
        return range(self.process_index * k, (self.process_index + 1) * k)

    def local(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This process's slabs of a tensor that holds all D on ``dim``."""
        r = self.local_slabs
        return x.narrow(dim, r.start, len(r))


def device_mesh_1d(n_devices: int | None = None, axis: str = "x"
                   ) -> SlabMesh:
    """The mesh of ``n_devices`` slabs (None: one a process) over the
    processes of the default group."""
    P = process_count()
    return SlabMesh(P if n_devices is None else n_devices, axis, P,
                    process_index())


def first_slab(local_slabs: int) -> int:
    """Global index of this process's first slab."""
    return process_index() * local_slabs


# ---------------------------------------------------------------------------
# The collectives. Each is the identity or a zero fill in one process.


def _gloo_staged() -> bool:
    return dist.get_backend() == "gloo"


def _to_wire(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.cpu() if _gloo_staged() else t


def edges(x: torch.Tensor, G: int, dim: int):
    """(above, below): the G global rows just before and just after this
    process's block ``x`` along ``dim`` (its slabs' rows, in order),
    zeros beyond the line's ends. A strip deeper than a block takes as
    many hops (JAX ``_exchange_strips``)."""
    shape = list(x.shape)
    shape[dim] = G
    zero = x.new_zeros(shape)
    P, r = process_count(), process_index()
    L = x.shape[dim]
    if P == 1 or G == 0:
        return zero, zero
    hops = -(-G // L)
    depth = [min(L, G - (h - 1) * L) for h in range(1, hops + 1)]
    wire = torch.device("cpu") if _gloo_staged() else x.device
    above, below, ops = {}, {}, []
    for h, k in enumerate(depth, start=1):
        if r + h < P:   # my last k rows are the rows above rank r + h
            ops.append(dist.P2POp(dist.isend,
                                  _to_wire(x.narrow(dim, L - k, k)), r + h,
                                  tag=2 * h))
            below[h] = torch.empty(x.narrow(dim, 0, k).shape,
                                   dtype=x.dtype, device=wire)
            ops.append(dist.P2POp(dist.irecv, below[h], r + h,
                                  tag=2 * h + 1))
        if r - h >= 0:  # my first k rows are the rows below rank r - h
            ops.append(dist.P2POp(dist.isend, _to_wire(x.narrow(dim, 0, k)),
                                  r - h, tag=2 * h + 1))
            above[h] = torch.empty(x.narrow(dim, 0, k).shape,
                                   dtype=x.dtype, device=wire)
            ops.append(dist.P2POp(dist.irecv, above[h], r - h, tag=2 * h))
    # one batch: no order of sends and receives between two ranks can
    # deadlock (nccl matches unbatched point-to-point calls in order)
    for w in dist.batch_isend_irecv(ops):
        w.wait()

    def part(got, h, k):
        return (got[h].to(x.device) if h in got
                else zero.narrow(dim, 0, k))

    return (torch.cat([part(above, h, depth[h - 1])
                       for h in range(hops, 0, -1)], dim=dim),
            torch.cat([part(below, h, depth[h - 1])
                       for h in range(1, hops + 1)], dim=dim))


def frame(x: torch.Tensor, G: int, dim: int = -2) -> torch.Tensor:
    """``x`` with the G global rows before and after it along ``dim``
    (zeros beyond the ends): in one process a zero pad."""
    if process_count() == 1:
        d = dim % x.dim()
        pad = [0, 0] * (x.dim() - 1 - d) + [G, G]
        return F.pad(x, pad)
    above, below = edges(x, G, dim)
    return torch.cat([above, x, below], dim=dim)


def psum(t: torch.Tensor) -> torch.Tensor:
    """A partial sum (a 0-d tensor) summed over the processes."""
    if process_count() == 1:
        return t
    w = _to_wire(t).clone()
    dist.all_reduce(w)
    return w.to(t.device)


def all_gather_slabs(x: torch.Tensor) -> torch.Tensor:
    """(D/P, ...) local slabs -> the (D, ...) slabs of every process, in
    slab order."""
    P = process_count()
    if P == 1:
        return x
    w = _to_wire(x)
    parts = [torch.empty_like(w) for _ in range(P)]
    dist.all_gather(parts, w)
    return torch.cat(parts).to(x.device)
