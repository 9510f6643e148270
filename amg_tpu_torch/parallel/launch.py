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
  (``all_gather_slabs``): ``all_gather``;
* the ghost strips of the slabs (``strips``): ``edges`` and a shift by
  one slab, the plain version of K7's peer form;
* card memory that the neighbour processes address directly
  (``peer_buffers``, ``free_peer_buffers``; ``open_peer_strips``,
  ``close_peer_strips`` lay K7's peer form out in it, ``halo="rdma"``):
  one ``cudaMalloc`` a buffer, its CUDA IPC handle exchanged once through
  ``all_gather_object``, the neighbours' opened.

The process group is torch.distributed's default group: a process that
has called ``initialize_distributed`` (or ``init_process_group``) with
more than one process runs the distributed solvers across processes;
any other runs them in one process, on the slab axis alone.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os

import torch
import torch.distributed as dist
import torch.nn.functional as F

from amg_tpu_torch.ops.kernels._build import check, library
from amg_tpu_torch.ops.kernels.halo import (PEER_TIMEOUT_S, PeerStrips,
                                            peer_layout,
                                            rdma_halo_exchange_plain)


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


def strips(x: torch.Tensor, G: int) -> torch.Tensor:
    """The (D, 2G, W) receive strips of this process's (D, B, W) slabs,
    G <= B: rows [0, G) the previous slab's last G rows, rows [G, 2G) the
    next slab's first G rows, the ones beyond the ends of the block from
    processes p-1 and p+1 (``edges``), zeros at the line's ends."""
    D, B, W = x.shape
    above, below = edges(x.reshape(D * B, W), G, dim=0)
    return rdma_halo_exchange_plain(x, G, above, below)


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


# ---------------------------------------------------------------------------
# Card memory the line neighbours address: the peer form of K7.


class _CudaBytes:
    """``nbytes`` bytes of card memory at ``ptr``, for ``torch.as_tensor``
    (``__cuda_array_interface__``); the memory stays its owner's."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "strides": None, "version": 3}


@dataclasses.dataclass
class PeerMemory:
    """One allocation of this process's card that processes p-1 and p+1
    have mapped: ``local`` its bytes as a tensor, ``above`` and ``below``
    the neighbours' allocations of the same size mapped here (0 beyond
    the line's ends). ``free_peer_buffers`` releases it."""

    local: torch.Tensor
    above: int
    below: int
    base: int
    device: int


def peer_buffers(nbytes: int) -> PeerMemory:
    """Collective: every process calls it with the same ``nbytes``. Each
    makes a zeroed ``cudaMalloc`` of its own on its current card (not a
    block of PyTorch's caching allocator: an IPC handle names a whole
    allocation), the 64-byte IPC handles go round once, and each process
    maps its line neighbours' allocations (with peer access when they lie
    on another card). Raises if a step fails; there is no other path."""
    if process_count() < 2:
        raise RuntimeError("peer_buffers needs a process group of two or "
                           "more processes")
    lib = library()
    dev = torch.cuda.current_device()
    base, handle = ctypes.c_void_p(), ctypes.create_string_buffer(64)
    check(lib.amg_ipc_alloc(dev, nbytes, ctypes.byref(base), handle),
          "amg_ipc_alloc")
    handles = [None] * process_count()
    dist.all_gather_object(handles, handle.raw)
    r = process_index()
    mapped = []
    for q in (r - 1, r + 1):
        ptr = ctypes.c_void_p()
        if 0 <= q < process_count():
            check(lib.amg_ipc_open(dev, handles[q], ctypes.byref(ptr)),
                  f"amg_ipc_open (process {q}'s memory)")
        mapped.append(ptr.value or 0)
    local = torch.as_tensor(_CudaBytes(base.value, nbytes),
                            device=f"cuda:{dev}")
    return PeerMemory(local, mapped[0], mapped[1], base.value, dev)


def free_peer_buffers(mems) -> None:
    """Collective: wait for this process's card, unmap the neighbours'
    allocations, wait for every process to have done the same (so no
    mapping of this process's memory is left), then free this process's.
    The ``local`` tensors must not be used after."""
    lib = library()
    torch.cuda.synchronize()
    for m in mems:
        for ptr in (m.above, m.below):
            if ptr:
                check(lib.amg_ipc_close(m.device, ptr), "amg_ipc_close")
        m.above = m.below = 0
    dist.barrier()
    for m in mems:
        if m.base:
            check(lib.amg_ipc_free(m.device, m.base), "amg_ipc_free")
        m.base = 0


def open_peer_strips(shapes, dtype, timeout_s: float = PEER_TIMEOUT_S
                     ) -> dict:
    """Collective, on the card: ``{(D, G, W): PeerStrips}``, K7's peer
    memory for each exchange shape (every process asks for the same
    shapes in the same order), with one status word between them."""
    status = torch.zeros(2, dtype=torch.int32, pin_memory=True)
    es = torch.empty((), dtype=dtype).element_size()
    return {(D, G, W): PeerStrips(
        D, G, W, dtype, peer_buffers(peer_layout(D, G, W, es)["nbytes"]),
        status, timeout_s) for D, G, W in shapes}


def close_peer_strips(strips: dict) -> None:
    """Collective: release what ``open_peer_strips`` made (after the card
    has finished with it), then raise if a wait had timed out."""
    free_peer_buffers([s.mem for s in strips.values()])
    for s in strips.values():
        s.check()
