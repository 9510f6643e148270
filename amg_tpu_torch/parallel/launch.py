"""Processes, cards, the slab mesh, and the one layer every collective of
the distributed solvers goes through.

PyTorch port of ``amg_tpu/parallel/launch.py``. The port's mesh is a
leading slab axis: a field of D row slabs is one (D, B, ...) tensor, and
inside one block every exchange is a tensor op on that axis (a shift, a
window of the padded field, a reshape). The D slabs are cut into P
blocks of D/P consecutive slabs, slab s in block s // (D/P), and the
layer below turns the slab-axis ops into transfers between the blocks.
A block is one of two things:

* a process of a ``torch.distributed`` group (``initialize_distributed``);
* a thread of a card group (``CardGroup``): one process drives K cards,
  one thread a block, each thread bound to its card (JAX's one-program
  mesh over the local devices, ``DistStructuredSolver(n_devices=None)``).

The collectives, in both forms:

* the rows a slab needs from its neighbours (``edges``, ``frame``): the
  strips at the ends of a block go to the neighbour blocks, as many hops
  as the strip is deep; by send/recv in one batch across processes
  (through host memory under gloo), by copies from the neighbour's card
  in a card group;
* the rss and the inner products (``psum``): ``all_reduce`` across
  processes; in a card group every block adds the K partials in block
  order;
* the agglomeration gather and the gathered field
  (``all_gather_slabs``): ``all_gather``, or copies in block order;
* the ghost strips of the slabs (``strips``): ``edges`` and a shift by
  one slab, the plain version of K7's peer form;
* card memory that the neighbour blocks address directly
  (``peer_buffers``, ``free_peer_buffers``; ``open_peer_strips``,
  ``close_peer_strips`` lay K7's peer form out in it, ``halo="rdma"``):
  one ``cudaMalloc`` a block; across processes its CUDA IPC handle goes
  round once through ``all_gather_object`` and the neighbours' are
  opened, in a card group the pointers are handed across directly and
  the cards of line neighbours get peer access.

A process that has called ``initialize_distributed`` (or
``init_process_group``) with more than one process runs the distributed
solvers across processes; a card thread runs them in its card group; any
other code runs them in one block, on the slab axis alone.
"""

from __future__ import annotations

import copy
import ctypes
import dataclasses
import functools
import os
import queue
import threading
import time
import weakref

import torch
import torch.distributed as dist
import torch.nn.functional as F

from amg_tpu_torch.ops.kernels._build import check, library
from amg_tpu_torch.ops.kernels.halo import (PEER_TIMEOUT_S, PeerStrips,
                                            peer_layout,
                                            rdma_halo_exchange_plain)
from amg_tpu_torch.utils.device import resolve_device

# how long a card thread waits at a collective for the others; a thread
# that raises breaks the wait at once
BARRIER_TIMEOUT_S = 300.0


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


# the card group of the current thread, and its block (card threads only)
_here = threading.local()


def _group():
    return getattr(_here, "group", None)


def process_count() -> int:
    """Blocks of the mesh: the card group's size in a card thread, else
    the processes in the default group (1 without one)."""
    g = _group()
    if g is not None:
        return g.size
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This block: the card thread's block, else the process's rank."""
    if _group() is not None:
        return _here.block
    return dist.get_rank() if dist.is_initialized() else 0


@dataclasses.dataclass(frozen=True)
class SlabMesh:
    """D row slabs over the blocks: block p holds the consecutive slabs
    ``[p * D/P, (p + 1) * D/P)``."""

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
        """This block's slabs of a tensor that holds all D on ``dim``."""
        r = self.local_slabs
        return x.narrow(dim, r.start, len(r))


def device_mesh_1d(n_devices: int | None = None, axis: str = "x"
                   ) -> SlabMesh:
    """The mesh of ``n_devices`` slabs (None: one a block) over the blocks
    of the card group or the default process group."""
    P = process_count()
    return SlabMesh(P if n_devices is None else n_devices, axis, P,
                    process_index())


def first_slab(local_slabs: int) -> int:
    """Global index of this block's first slab."""
    return process_index() * local_slabs


# ---------------------------------------------------------------------------
# Where the slabs go.


def slab_devices(n_slabs: int | None, device=None) -> tuple:
    """(D, the blocks' devices) of a distributed solver of ``n_slabs``
    slabs (JAX ``jax.devices()[:D]``):

    * ``device`` None in a process outside a process group: the first K'
      visible cards, K' the largest divisor of D that is at most
      ``torch.cuda.device_count()``, each holding D/K' consecutive slabs;
      ``n_slabs`` None is one slab a card. With one card, every slab on
      ``"cuda"``;
    * one device (``"cuda"``, ``"cuda:1"``, ``"cpu"``), or ``device`` None
      in a process of a process group (its current card): every slab of
      the block there (``n_slabs`` None: the visible cards);
    * a sequence of devices: one block of D/K slabs on each of its K
      entries (``n_slabs`` None: one slab an entry). Raises under a
      process group: P processes of K cards each is not built.

    Raises without a card where one is needed."""
    if isinstance(device, (list, tuple)):
        if process_count() > 1:
            raise ValueError("a sequence of devices gives a card group of "
                             "one process; under a process group each "
                             "process takes one device")
        devices = tuple(torch.device(d) for d in device)
        D = len(devices) if n_slabs is None else n_slabs
        if not devices or D % len(devices):
            raise ValueError(f"{D} slabs do not split over the "
                             f"{len(devices)} devices {device}")
        return D, devices
    if device is not None or process_count() > 1:
        device = resolve_device(device)
        return (visible_cards() if n_slabs is None else n_slabs), (device,)
    resolve_device(None)                    # raises without a card
    cards = visible_cards()
    D = cards if n_slabs is None else n_slabs
    K = max(k for k in range(1, min(D, cards) + 1) if D % k == 0)
    if K == 1:
        return D, (torch.device("cuda"),)
    return D, tuple(torch.device("cuda", i) for i in range(K))


def visible_cards() -> int:
    """The visible CUDA devices (raises without one): ``n_devices=None``."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("n_devices=None counts the visible CUDA devices "
                           "and there are none; pass n_devices")
    return n


# ---------------------------------------------------------------------------
# The card group: one process, K blocks, a thread a block.


class CardGroup:
    """K long-lived threads, thread k the block k on ``devices[k]`` (a
    card, or the CPU). Each card thread calls ``torch.cuda.set_device``
    once and takes a stream of its own: the current device and the
    current stream are per thread, so two blocks on one card run on two
    streams. ``run(fn)`` runs ``fn(k)`` on every thread; inside it this
    module's collectives go between the threads. An exception on a thread
    breaks the others' collectives, ``run`` raises it in the caller, and
    the group takes no more work. ``close()`` ends the threads."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        self.size = len(self.devices)
        self._cards = sorted({d for d in self.devices if d.type == "cuda"},
                             key=lambda d: d.index)
        self._barrier = threading.Barrier(self.size,
                                          timeout=BARRIER_TIMEOUT_S)
        # two sets of slots, used in turn: a block writes set g % 2 only
        # after every block has passed collective g - 1, so after it read
        # set g % 2 at collective g - 2
        self._slots = ([None] * self.size, [None] * self.size)
        self._turn = [0] * self.size
        self._tasks = [queue.SimpleQueue() for _ in range(self.size)]
        self._done = queue.SimpleQueue()
        self.failed = None
        self._threads = [threading.Thread(target=self._main, args=(k,),
                                          name=f"card-group-block-{k}",
                                          daemon=True)
                         for k in range(self.size)]
        for t in self._threads:
            t.start()

    def _main(self, k: int) -> None:
        _here.group, _here.block = self, k
        dev = self.devices[k]
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            torch.cuda.set_stream(torch.cuda.Stream(dev))
        while True:
            fn = self._tasks[k].get()
            if fn is None:
                return
            try:
                out = fn(k)
                if dev.type == "cuda":
                    torch.cuda.current_stream().synchronize()
            except BaseException as exc:    # handed to the caller
                self._barrier.abort()
                self._done.put((k, None, exc))
            else:
                self._done.put((k, out, None))
            fn = out = None

    def exchange(self, value) -> list:
        """Collective in a card thread: every block's ``value``, in block
        order."""
        k = _here.block
        slots = self._slots[self._turn[k] % 2]
        self._turn[k] += 1
        slots[k] = value
        self._barrier.wait()
        return list(slots)

    def run(self, fn) -> list:
        """``fn(k)`` on every block's thread; the results in block order.
        The caller's card work is finished first and each thread's after
        ``fn``, so the results are ready to use. Raises the first
        exception a thread raised (the others' broken collectives, or
        none, follow it); after a failure, once every thread has ended its
        task or ``BARRIER_TIMEOUT_S`` + ``PEER_TIMEOUT_S`` have passed."""
        if self.failed is not None:
            raise RuntimeError("the card group failed earlier") \
                from self.failed
        for d in self._cards:
            torch.cuda.synchronize(d)
        for q in self._tasks:
            q.put(fn)
        out, errors, deadline = [None] * self.size, [], None
        for _ in range(self.size):
            wait = (None if deadline is None
                    else max(deadline - time.monotonic(), 0.0))
            try:
                k, res, exc = self._done.get(timeout=wait)
            except queue.Empty:
                break
            if exc is not None:
                errors.append(exc)
                deadline = deadline or (time.monotonic() + BARRIER_TIMEOUT_S
                                        + PEER_TIMEOUT_S)
            out[k] = res
        self._slots = ([None] * self.size, [None] * self.size)
        if errors:
            first = [e for e in errors
                     if not isinstance(e, threading.BrokenBarrierError)]
            self.failed = (first or errors)[0]
            raise self.failed
        return out

    def stop(self) -> None:
        """Let the threads end after their current task, without waiting
        (a spread solver dropped unclosed)."""
        for q in self._tasks:
            q.put(None)

    def close(self) -> None:
        """End the threads (after their current task); the group takes no
        more work."""
        self.stop()
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=BARRIER_TIMEOUT_S)
        self.failed = self.failed or RuntimeError("the card group is closed")


def in_card_group() -> bool:
    """True in a thread of a card group."""
    return _group() is not None


class SpreadSolver:
    """What a distributed solver needs to spread its blocks over a card
    group: ``_spread`` builds the group and a copy of the solver on each
    block's thread, ``run`` calls a function of a block on every block,
    ``_close_group`` ends it. ``_blocks`` is None on a solver of one
    block (and on each block)."""

    _group = None
    _blocks = None

    def _spread(self, place) -> None:
        """Make this solver a card group over ``self.devices``: on each
        block's thread ``place(copy, device)`` puts a shallow copy of this
        solver's setup on the block's device and returns it."""
        block = copy.copy(self)
        group = CardGroup(self.devices)
        try:
            self._blocks = group.run(
                lambda k: place(copy.copy(block), group.devices[k]))
        except BaseException:
            group.close()
            raise
        self._group = group
        weakref.finalize(self, group.stop)

    def run(self, fn):
        """``fn(solver)``: on a solver spread over a card group on every
        block's thread with the block's solver (block 0's result), else on
        this one. The slab-level methods work on one block's slabs."""
        if self._blocks is None:
            return fn(self)
        return self._group.run(lambda k: fn(self._blocks[k]))[0]

    def _close_group(self, close_block) -> None:
        """``close_block(block)`` on every block unless the group failed,
        then end the threads; the solver is not used after."""
        group, blocks = self._group, self._blocks
        self._group = self._blocks = None
        try:
            if group.failed is None:
                group.run(lambda k: close_block(blocks[k]))
        finally:
            group.close()


def every_block(method):
    """A distributed solver's method that, on a solver spread over a card
    group (``self._blocks``), runs on every block's thread with the
    block's own solver and returns block 0's result: one whose value is
    the same on every block (a solve's gathered u, its counts and rss)."""
    @functools.wraps(method)
    def run(self, *args, **kw):
        if self._blocks is None:
            return method(self, *args, **kw)
        return self._group.run(
            lambda k: method(self._blocks[k], *args, **kw))[0]
    return run


def block_local(method):
    """A method that takes or returns one block's slabs: on a solver
    spread over a card group it is called on a block, inside ``run``."""
    @functools.wraps(method)
    def call(self, *args, **kw):
        if self._blocks is not None:
            raise RuntimeError(
                f"{method.__name__} works on one block's slabs; on a solver "
                f"spread over {len(self._blocks)} cards call it inside "
                f"run(lambda block: block.{method.__name__}(...))")
        return method(self, *args, **kw)
    return call


def _ready(x: torch.Tensor):
    """An event after the work on the current stream that made ``x``
    (None on the CPU)."""
    if not x.is_cuda:
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(x.device))
    return ev


def _pull(x: torch.Tensor, views: dict) -> dict:
    """Collective in a card thread: ``{q: views[q](x_q)}``, copied to this
    block's device, ``x_q`` the ``x`` of block q. On the card each copy
    runs on this thread's stream of the source card after an event of the
    source block's stream, and the source block's stream then waits for
    the copies of its ``x``: the caching allocator reuses ``x``'s memory
    only for work that follows them."""
    g, k = _group(), _here.block
    posted = g.exchange((x, _ready(x)))
    mine = g.devices[k]
    got, done = {}, {}
    for q, view in views.items():
        src, ready = posted[q]
        v = view(src)
        if v.is_cuda:
            s = torch.cuda.current_stream(v.device)
            s.wait_event(ready)
            got[q] = v.to(mine, copy=True)
            done[q] = torch.cuda.Event()
            done[q].record(s)
        else:
            got[q] = v.to(mine, copy=True)
    for marks in g.exchange(done):
        if k in marks:
            torch.cuda.current_stream(x.device).wait_event(marks[k])
    return got


# ---------------------------------------------------------------------------
# The collectives. Each is the identity or a zero fill in one block.


def _gloo_staged() -> bool:
    return dist.get_backend() == "gloo"


def _to_wire(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.cpu() if _gloo_staged() else t


def edges(x: torch.Tensor, G: int, dim: int):
    """(above, below): the G global rows just before and just after this
    block ``x`` along ``dim`` (its slabs' rows, in order), zeros beyond
    the line's ends. A strip deeper than a block takes as many hops (JAX
    ``_exchange_strips``)."""
    shape = list(x.shape)
    shape[dim] = G
    zero = x.new_zeros(shape)
    P, r = process_count(), process_index()
    L = x.shape[dim]
    if P == 1 or G == 0:
        return zero, zero
    hops = -(-G // L)
    depth = [min(L, G - (h - 1) * L) for h in range(1, hops + 1)]
    if _group() is not None:
        above, below = _edges_cards(x, dim, depth)
    else:
        above, below = _edges_processes(x, dim, depth)

    def part(got, h, k):
        return got[h] if h in got else zero.narrow(dim, 0, k)

    return (torch.cat([part(above, h, depth[h - 1])
                       for h in range(hops, 0, -1)], dim=dim),
            torch.cat([part(below, h, depth[h - 1])
                       for h in range(1, hops + 1)], dim=dim))


def _edges_processes(x, dim: int, depth: list):
    """``edges``' strips by hop across processes: one batch of send/recv."""
    P, r = process_count(), process_index()
    L = x.shape[dim]
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
    return ({h: t.to(x.device) for h, t in above.items()},
            {h: t.to(x.device) for h, t in below.items()})


def _edges_cards(x, dim: int, depth: list):
    """``edges``' strips by hop in a card group: copies of the last rows
    of block r - h and the first rows of block r + h."""
    P, r = process_count(), process_index()
    L = x.shape[dim]
    views, hop = {}, {}
    for h, k in enumerate(depth, start=1):
        if r - h >= 0:
            views[r - h] = lambda t, k=k: t.narrow(dim, L - k, k)
            hop[r - h] = h
        if r + h < P:
            views[r + h] = lambda t, k=k: t.narrow(dim, 0, k)
            hop[r + h] = h
    got = _pull(x, views)
    return ({hop[q]: t for q, t in got.items() if q < r},
            {hop[q]: t for q, t in got.items() if q > r})


def frame(x: torch.Tensor, G: int, dim: int = -2) -> torch.Tensor:
    """``x`` with the G global rows before and after it along ``dim``
    (zeros beyond the ends): in one block a zero pad."""
    if process_count() == 1:
        d = dim % x.dim()
        pad = [0, 0] * (x.dim() - 1 - d) + [G, G]
        return F.pad(x, pad)
    above, below = edges(x, G, dim)
    return torch.cat([above, x, below], dim=dim)


def strips(x: torch.Tensor, G: int) -> torch.Tensor:
    """The (D, 2G, W) receive strips of this block's (D, B, W) slabs,
    G <= B: rows [0, G) the previous slab's last G rows, rows [G, 2G) the
    next slab's first G rows, the ones beyond the ends of the block from
    blocks p-1 and p+1 (``edges``), zeros at the line's ends."""
    D, B, W = x.shape
    above, below = edges(x.reshape(D * B, W), G, dim=0)
    return rdma_halo_exchange_plain(x, G, above, below)


def psum(t: torch.Tensor) -> torch.Tensor:
    """A partial sum (a 0-d tensor) summed over the blocks. In a card
    group every block adds the K partials in block order, the same
    operations on the same values: every block holds the same bits (PCG's
    step sizes and the stop test read them)."""
    P = process_count()
    if P == 1:
        return t
    if _group() is not None:
        parts = _pull(t, {q: lambda v: v for q in range(P)})
        total = parts[0]
        for q in range(1, P):
            total = total + parts[q]
        return total
    w = _to_wire(t).clone()
    dist.all_reduce(w)
    return w.to(t.device)


def all_gather_slabs(x: torch.Tensor) -> torch.Tensor:
    """(D/P, ...) local slabs -> the (D, ...) slabs of every block, in
    slab order."""
    P = process_count()
    if P == 1:
        return x
    if _group() is not None:
        parts = _pull(x, {q: lambda v: v for q in range(P)})
        return torch.cat([parts[q] for q in range(P)])
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
    """One allocation of this block's card that blocks p-1 and p+1
    address: ``local`` its bytes as a tensor, ``above`` and ``below`` the
    neighbours' allocations of the same size as this card reaches them
    (mapped through CUDA IPC across processes, their own pointers in a
    card group; 0 beyond the line's ends). ``free_peer_buffers`` releases
    it."""

    local: torch.Tensor
    above: int
    below: int
    base: int
    device: int


def peer_buffers(nbytes: int) -> PeerMemory:
    """Collective: every block calls it with the same ``nbytes``. Each
    makes a zeroed ``cudaMalloc`` of its own on its current card (not a
    block of PyTorch's caching allocator: an IPC handle names a whole
    allocation, and the memory must outlive the streams' reuse). Across
    processes the 64-byte IPC handles go round once and each process maps
    its line neighbours' allocations (with peer access when they lie on
    another card); in a card group the pointers are handed across and
    each card gets peer access to its line neighbours' cards (none where
    both blocks are on one card). Raises if a step fails; there is no
    other path."""
    if process_count() < 2:
        raise RuntimeError("peer_buffers needs a process group or a card "
                           "group of two or more blocks")
    lib = library()
    dev = torch.cuda.current_device()
    base = ctypes.c_void_p()
    r = process_index()
    mapped = []
    if _group() is not None:
        check(lib.amg_peer_alloc(dev, nbytes, ctypes.byref(base)),
              "amg_peer_alloc")
        posted = _group().exchange((dev, base.value))
        for q in (r - 1, r + 1):
            if not 0 <= q < process_count():
                mapped.append(0)
                continue
            q_dev, ptr = posted[q]
            if q_dev != dev:
                check(lib.amg_peer_enable(dev, q_dev),
                      f"amg_peer_enable (card {dev} to card {q_dev})")
            mapped.append(ptr)
    else:
        handle = ctypes.create_string_buffer(64)
        check(lib.amg_ipc_alloc(dev, nbytes, ctypes.byref(base), handle),
              "amg_ipc_alloc")
        handles = [None] * process_count()
        dist.all_gather_object(handles, handle.raw)
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
    """Collective: wait for this block's card; across processes unmap the
    neighbours' allocations; wait for every block to have done the same
    (so no launch that writes this block's memory and no mapping of it is
    left), then free this block's. The ``local`` tensors must not be used
    after."""
    lib = library()
    torch.cuda.synchronize()
    if _group() is not None:
        _group().exchange(None)
    else:
        for m in mems:
            for ptr in (m.above, m.below):
                if ptr:
                    check(lib.amg_ipc_close(m.device, ptr),
                          "amg_ipc_close")
        dist.barrier()
    for m in mems:
        m.above = m.below = 0
        if m.base:
            check(lib.amg_peer_free(m.device, m.base), "amg_peer_free")
        m.base = 0


def open_peer_strips(shapes, dtype, timeout_s: float = PEER_TIMEOUT_S
                     ) -> dict:
    """Collective, on the card: ``{(D, G, W): PeerStrips}``, K7's peer
    memory for each exchange shape (every block asks for the same shapes
    in the same order), with one status word between them."""
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
