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
* the rss and the inner products (``psum``): every block's partial
  gathered (``all_gather`` across processes, copies in a card group) and
  added in block order on every block, so every block holds the same
  bits for any form of the mesh;
* the agglomeration gather and the gathered field
  (``all_gather_slabs``): ``all_gather``, or copies in block order;
* the ghost strips of the slabs (``strips``): ``edges`` and a shift by
  one slab, the plain version of K7's peer form;
* card memory that other blocks address directly (``peer_buffers``,
  ``free_peer_buffers``; ``open_peer_strips``, ``close_peer_strips`` lay
  K7's peer form out in it, ``halo="rdma"``; ``GroupCollectives`` the
  peer collective kernel's): one ``cudaMalloc`` a block; across
  processes its CUDA IPC handle goes round once through
  ``all_gather_object`` and the other processes' are opened, in a card
  group the pointers are handed across directly and the cards get peer
  access.

Inside the distributed solvers' CUDA graphs (``ProgramSolver``'s graph
driver) the same collectives are the peer collective kernel
(``device_collectives``): one launch a collective, over the blocks of a
card group, of the processes, or of both.

The two nest: P processes, each driving a card group of K blocks, are
one mesh of P·K blocks (JAX's multi-host mesh), block p·K + k the thread
k of process p. There ``process_count`` and ``process_index`` answer
P·K and p·K + k, while ``world_size`` and ``world_rank`` keep the
process group's P and p. One thread of each group, its block 0 (the
lead), issues every ``torch.distributed`` call of the process, in one
order on every process; the other blocks hand it their data, and take
theirs from it, through the group's copies (``_pull``). The strips of
``edges`` cross the processes as the process's whole line of K blocks
(``_edges_group``), ``psum`` gathers the K partials before the lead's
``all_gather``, and peer memory is a pointer between two blocks of a
process and a CUDA IPC mapping between two processes.

A process that has called ``initialize_distributed`` (or
``init_process_group``) with more than one process runs the distributed
solvers across processes; a card thread runs them in its card group
(across the processes too, when there are several); any other code runs
them in one block, on the slab axis alone.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import dataclasses
import functools
import gc
import os
import queue
import threading
import time
import weakref

import torch
import torch.distributed as dist
import torch.nn.functional as F

from amg_tpu_torch.ops.kernels._build import check, library
from amg_tpu_torch.ops.kernels import graph_loop
from amg_tpu_torch.ops.kernels import peer_collective as _pc
from amg_tpu_torch.ops.kernels.halo import (PEER_TIMEOUT_S, PeerStrips,
                                            peer_layout,
                                            rdma_halo_exchange_plain)
from amg_tpu_torch.ops.kernels.peer_collective import (GATHER, SUM,
                                                       peer_collective)
from amg_tpu_torch.utils.device import resolve_device

# how long a card thread waits at a collective for the others; a thread
# that raises breaks the wait at once
BARRIER_TIMEOUT_S = 300.0


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           local_devices: int | None = None) -> dict:
    """Join the process group: ``coordinator_address`` ("host:port") with
    ``num_processes`` and ``process_id``, else the ``env://`` variables
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK). Each process owns K =
    ``local_devices`` cards (None: the visible cards over the processes,
    at least 1): with every card visible process p owns cards p·K …
    p·K + K - 1, and a process that sees only K cards (its
    ``CUDA_VISIBLE_DEVICES``) owns them all. The backend is "nccl" when
    each process owns cards of its own (its current card is its first,
    ``local_cards()`` are all) and "gloo" otherwise, the processes
    sharing the cards. nccl carries card tensors only: processes that run
    the solvers on the CPU hide the cards (``CUDA_VISIBLE_DEVICES=""``).
    Returns JAX's dict: ``local_devices`` K and ``global_devices`` P·K,
    where a device of the mesh is a block (a solver of D slabs holds
    ``device_mesh_1d(D).slabs_per_process`` a block; one block a process
    unless it is given a sequence of devices, ``slab_devices``)."""
    global _local_cards
    if coordinator_address is not None:
        init = f"tcp://{coordinator_address}"
        world, rank = num_processes, process_id
    else:
        init = "env://"
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    K = local_devices or max(n_cards // world, 1)
    if n_cards >= world * K:
        first = rank * K
    elif local_devices is not None and n_cards == K:
        first = 0                           # each process sees its own
    else:
        first = None                        # the processes share the cards
    backend = "nccl" if first is not None else "gloo"
    if first is not None:
        torch.cuda.set_device(first)
        _local_cards = tuple(torch.device("cuda", first + k)
                             for k in range(K))
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank)
    return dict(process_index=world_rank(), process_count=world_size(),
                local_devices=K, global_devices=world * K)


# the cards this process owns under nccl (initialize_distributed)
_local_cards = None


def local_cards() -> tuple:
    """The cards this process owns (``initialize_distributed``): its K
    cards under nccl; else the current card alone (the processes share
    the cards under gloo, and a process outside a group has the one)."""
    return _local_cards or (torch.device("cuda",
                                         torch.cuda.current_device()),)


def world_size() -> int:
    """The processes of the default process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    """This process's rank in the default process group (0 without
    one)."""
    return dist.get_rank() if dist.is_initialized() else 0


# the card group of the current thread, and its block (card threads only)
_here = threading.local()


def _group():
    return getattr(_here, "group", None)


def _mesh() -> bool:
    """True in a card thread of a process group of several processes."""
    return _group() is not None and world_size() > 1


def process_count() -> int:
    """Blocks of the mesh: P·K in a card thread of a card group of K
    blocks in each of P processes (K alone without a process group),
    else the processes in the default group (1 without one)."""
    g = _group()
    if g is not None:
        return g.size * world_size()
    return world_size()


def process_index() -> int:
    """This block: p·K + k in card thread k of process p, else the
    process's rank."""
    if _group() is not None:
        return world_rank() * _group().size + _here.block
    return world_rank()


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
    * a sequence of K devices: one block of D/K slabs on each entry
      (``n_slabs`` None: one slab an entry); under a process group of P
      processes, each giving its own K, the process's K blocks of the
      mesh of P·K, D/(P·K) slabs each (block p·K + k on entry k of
      process p).

    Raises without a card where one is needed."""
    if isinstance(device, (list, tuple)):
        devices = tuple(torch.device(d) for d in device)
        blocks = len(devices) * world_size()
        D = blocks if n_slabs is None else n_slabs
        if not devices or D % blocks:
            where = ("" if world_size() == 1 else
                     f" of each of {world_size()} processes")
            raise ValueError(f"{D} slabs do not split over the "
                             f"{len(devices)} devices {device}{where}")
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
    the group takes no more work. ``close()`` ends the threads. Under a
    process group every process makes a group of the same size, and
    together they are the mesh: block 0's thread of each issues the
    process's ``torch.distributed`` calls."""

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
        if self._cards:
            # no garbage collection in the threads while they run: freeing
            # a dropped CUDA graph (its memory pool) waits for the whole
            # card, which in a card thread can wait for another block's
            # collective that waits for that thread; dropped graphs are
            # freed here, where no block runs
            graph_loop._free_retired()
            collect = gc.isenabled()
            gc.disable()
        else:
            collect = False
        try:
            return self._run(fn)
        finally:
            if collect:
                gc.enable()

    def _run(self, fn) -> list:
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


class ProgramSolver(SpreadSolver):
    """A distributed solver whose JAX programs are restated in cond/body
    form on fixed buffers a block (``_state()``: ``straight``, the pieces
    with no loop, and ``loops``, each a ``graph_loop.DeviceLoop`` with
    its (pre, post)) and run under one of two drivers, ``driver``:

    * ``"graph"`` (the default whenever every block is on a card: one
      block, a card group, a process group or the mesh of both): a CUDA
      graph a program a block, captured at its first use (``_build``) or
      by ``warmup``, one graph launch a call; over several blocks the
      collectives inside are the peer collective kernel on
      ``GroupCollectives`` the blocks open at the first capture, so no
      host collective and no host read happens inside a call;
    * ``"host"`` (the CPU's, and the oracle on the card): the same pieces
      stepped from the host, the collectives the host ones.

    Under a process group every program call is collective, as in JAX's
    multi-host ``shard_map``: every process calls the same programs in
    the same order (``warmup`` captures them in one order on every
    process), and a capture ends with every block of the mesh at a
    barrier before any launches, so no block's first launch waits on
    another's capture. A block sets ``_loop`` (its ``_state``),
    ``_graphs`` and ``_coll`` to None, {} and None when it is placed."""

    def _driver_for(self, driver: str | None) -> str:
        on_card = all(d.type == "cuda" for d in self.devices)
        if driver is None:
            return "graph" if on_card else "host"
        if driver not in ("graph", "host"):
            raise ValueError(f"unknown driver {driver!r}: 'graph' or 'host'")
        if driver == "graph" and not on_card:
            raise ValueError(
                "the graph driver runs on the card; on the CPU the solver "
                "takes the host driver")
        return driver

    def set_driver(self, driver: str | None) -> None:
        """Run the programs under ``driver`` from now on (None: the
        default), on every block."""
        self.driver = self._driver_for(driver)
        for blk in self._blocks or ():
            blk.driver = self.driver

    def _build(self, name: str) -> None:
        """Under the graph driver, the program's graph on this block,
        captured at its first use (JAX compiles at the first call); over
        several blocks (collective) every block captures together, the
        collectives inside the peer collective kernel on memory the blocks
        open at the first capture and size in the warm-up, and every
        block of the mesh meets at a barrier before the capture and after
        it."""
        if self.driver != "graph" or name in self._graphs:
            return
        L = self._state()
        spread = process_count() > 1
        if spread and self._coll is None:
            self._coll = GroupCollectives()
        wait = functools.partial(barrier, processes=True) if spread else None
        warm = ((lambda: sizing_collectives(self._coll)) if spread
                else None)
        with device_collectives(self._coll):
            if name in L.loops:
                loop, pre, post = L.loops[name]
                g = loop.graph(pre, post, barrier=wait, warm=warm)
            else:
                g = graph_loop.StraightGraph(L.straight[name], self.device,
                                             barrier=wait, warm=warm)
        self._graphs[name] = g

    def _go(self, name: str) -> None:
        """One run of the program on its buffers: one graph launch, or
        the host driver of the same pieces."""
        L = self._state()
        if self.driver == "graph":
            # in a card group every block's graph is launched before any
            # block goes on (an allocation after it could hold the card
            # before another block's launch); across processes nothing:
            # each context waits for its own work only
            barrier()
            self._graphs[name].launch()
            barrier()
        elif name in L.loops:
            loop, pre, post = L.loops[name]
            loop.run_host(pre, post)
        else:
            L.straight[name]()

    def _run(self, name: str, inputs):
        """The program's graph built (its warm-up runs the pieces once
        on the buffers), ``inputs()`` written into its buffers, one
        run. Returns the block's ``_state``."""
        self._build(name)
        inputs()
        self._go(name)
        return self._state()

    def _check(self) -> None:
        """After a read of a program's results: raise if a wait of the
        peer collectives timed out."""
        if self._coll is not None:
            self._coll.check()

    @every_block
    def warmup(self) -> None:
        """JAX's compile step: under the graph driver capture and
        instantiate every program's graph on every block (the first call
        of each does it otherwise). Collective under a process group:
        every process calls it, and the programs are captured in one
        order."""
        L = self._state()
        for name in (*L.straight, *L.loops):
            self._build(name)

    def _close_programs(self) -> None:
        """Drop the block's graphs and release the peer collectives'
        memory (collective over several blocks)."""
        self._graphs = {}
        if self._coll is not None:
            coll, self._coll = self._coll, None
            coll.close()


def _ready(x):
    """An event after the work on the current stream that made ``x`` (a
    tensor or a tuple of tensors on one device; None on the CPU)."""
    x = x[0] if isinstance(x, tuple) else x
    if not x.is_cuda:
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(x.device))
    return ev


def _pull(x, wants: list) -> list:
    """Collective in a card thread: ``[view(x_q) for q, view in wants]``,
    copied to this block's device, ``x_q`` the ``x`` of block q (a tensor,
    or a tuple of tensors on one device). On the card each copy runs on
    this thread's stream of the source card after an event of the source
    block's stream, and the source block's stream then waits for the
    copies of its ``x``: the caching allocator reuses ``x``'s memory only
    for work that follows them."""
    g, k = _group(), _here.block
    posted = g.exchange((x, _ready(x)))
    mine = g.devices[k]
    got, done = [], {}
    for q, view in wants:
        src, ready = posted[q]
        v = view(src)
        if v.is_cuda:
            s = torch.cuda.current_stream(v.device)
            s.wait_event(ready)
            got.append(v.to(mine, copy=True))
            done[q] = torch.cuda.Event()
            done[q].record(s)
        else:
            got.append(v.to(mine, copy=True))
    first = x[0] if isinstance(x, tuple) else x
    for marks in g.exchange(done):
        if k in marks:
            torch.cuda.current_stream(first.device).wait_event(marks[k])
    return got


def _identity(t):
    return t


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
    if process_count() == 1 or G == 0:
        return zero, zero
    L = x.shape[dim]
    mem = _device_form(x, 2 * min(G, L) * (x.numel() // max(L, 1))
                       * x.element_size())
    if mem is not None:
        return _edges_device(x, G, dim, mem)
    if _group() is not None:
        return _edges_group(x, G, dim)
    above, below = _edges_processes(
        lambda k: x.narrow(dim, 0, k), lambda k: x.narrow(dim, L - k, k), x,
        dim, _depths(L, G), process_count(), process_index())
    return _by_hop(above, below, zero, dim, _depths(L, G))


def _depths(L: int, G: int) -> list:
    """The rows of each hop of a G-row strip over lines of L rows."""
    return [min(L, G - (h - 1) * L) for h in range(1, -(-G // L) + 1)]


def _by_hop(above: dict, below: dict, zero, dim: int, depth: list):
    """The strips from their hops (zeros for a hop beyond the line)."""
    def part(got, h, k):
        return got[h] if h in got else zero.narrow(dim, 0, k)

    hops = len(depth)
    return (torch.cat([part(above, h, depth[h - 1])
                       for h in range(hops, 0, -1)], dim=dim),
            torch.cat([part(below, h, depth[h - 1])
                       for h in range(1, hops + 1)], dim=dim))


def _edges_processes(first, last, like, dim: int, depth: list, P: int,
                     r: int):
    """The strips by hop across the P processes, this one rank r: one
    batch of send/recv of its line's ``first(k)`` and ``last(k)`` rows
    (``like``: a tensor of the line's dtype, device and shape)."""
    wire = torch.device("cpu") if _gloo_staged() else like.device
    above, below, ops = {}, {}, []
    for h, k in enumerate(depth, start=1):
        shape = list(like.shape)
        shape[dim] = k
        if r + h < P:   # my last k rows are the rows above rank r + h
            ops.append(dist.P2POp(dist.isend, _to_wire(last(k)), r + h,
                                  tag=2 * h))
            below[h] = torch.empty(shape, dtype=like.dtype, device=wire)
            ops.append(dist.P2POp(dist.irecv, below[h], r + h,
                                  tag=2 * h + 1))
        if r - h >= 0:  # my first k rows are the rows below rank r - h
            ops.append(dist.P2POp(dist.isend, _to_wire(first(k)), r - h,
                                  tag=2 * h + 1))
            above[h] = torch.empty(shape, dtype=like.dtype, device=wire)
            ops.append(dist.P2POp(dist.irecv, above[h], r - h, tag=2 * h))
    # one batch: no order of sends and receives between two ranks can
    # deadlock (nccl matches unbatched point-to-point calls in order)
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return ({h: t.to(like.device) for h, t in above.items()},
            {h: t.to(like.device) for h, t in below.items()})


def _edges_group(x, G: int, dim: int):
    """``edges`` in a card group: the process's line is its K blocks of L
    rows (Lp = K·L), framed by the G rows above and below it, F = [above
    | block 0 | … | block K-1 | below], and block k takes its strips,
    F[kL, kL + G) and F[kL + G + L, kL + 2G + L), by copies from the
    blocks that hold them. Without a process group the frame is zeros;
    in the mesh the lead gathers the line's first and last min(G, Lp)
    rows, exchanges them with the other processes (``_edges_processes``)
    and posts the frame. The bits are the copies' own, those of one
    block."""
    K, k = _group().size, _here.block
    L = x.shape[dim]
    Lp = K * L
    post = (x,)
    if _mesh():
        T = min(G, Lp)
        wants = []          # (block, view, first row in the line)
        if k == 0:
            for q in range(K):
                cut = [(max(q * L, a) - q * L, min(q * L + L, b) - q * L)
                       for a, b in ((0, T), (Lp - T, Lp))
                       if max(q * L, a) < min(q * L + L, b)]
                if cut:
                    lo, hi = min(c[0] for c in cut), max(c[1] for c in cut)
                    wants.append((q, lambda t, lo=lo, hi=hi:
                                  t.narrow(dim, lo, hi - lo), q * L + lo))
        got = _pull(x, [(q, v) for q, v, _ in wants])
        if k == 0:
            pieces = [(start, t) for (_, _, start), t in zip(wants, got)]

            def rows(a, n):
                """Rows [a, a + n) of the line, from the pieces."""
                out = []
                for start, t in pieces:
                    lo, hi = max(a, start), min(a + n, start + t.shape[dim])
                    if lo < hi:
                        out.append(t.narrow(dim, lo - start, hi - lo))
                return torch.cat(out, dim=dim)

            shape = list(x.shape)
            shape[dim] = G
            above, below = _edges_processes(
                lambda n: rows(0, n), lambda n: rows(Lp - n, n), x, dim,
                _depths(Lp, G), world_size(), world_rank())
            post = (x, torch.cat(_by_hop(above, below, x.new_zeros(shape),
                                         dim, _depths(Lp, G)), dim=dim))

    def strip(a: int, e: int) -> list:
        return _frame_pieces(a, e, G, L, K, 0 if _mesh() else None)

    up = strip(k * L, k * L + G)
    down = strip(k * L + G + L, k * L + 2 * G + L)
    wants = [(q, lambda t, part=part, o=o, n=n: t[part].narrow(dim, o, n))
             for q, part, o, n in up + down if q is not None]
    got = iter(_pull(post, wants))
    parts = []
    for q, _, _, n in up + down:
        if q is None:
            shape = list(x.shape)
            shape[dim] = n
            parts.append(x.new_zeros(shape))
        else:
            parts.append(next(got))
    return (torch.cat(parts[:len(up)], dim=dim),
            torch.cat(parts[len(up):], dim=dim))


def _frame_pieces(a: int, e: int, G: int, L: int, K: int, outside) -> list:
    """Rows [a, e) of a line's frame F = [above | block 0 | … | block K-1
    | below] (G rows above and below, K blocks of L rows) as pieces
    (block, part, first row, rows): part 0 a block's own rows, part 1
    the rows beyond the K blocks, block ``outside``'s frame of them (the
    lead's, in the mesh), or zeros (``outside`` None: the K blocks are
    the whole line)."""
    Lp = K * L
    out = []
    while a < e:
        if G <= a < G + Lp:
            q, o = divmod(a - G, L)
            out.append((q, 0, o, min(e - a, L - o)))
        else:
            o = a if a < G else a - Lp
            n = min(e, G) - a if a < G else e - a
            out.append((outside, 1, o, n))
        a += out[-1][3]
    return out


def _edges_device(x, G: int, dim: int, mem):
    """``edges`` under ``device_collectives``: one gather (the peer
    collective kernel) of the first and last T = min(G, L) rows of every
    block of the mesh (the N = ``process_count()`` blocks of a card
    group, of the processes, or of both), from which each block takes the
    pieces of its strips in the frame of the whole line (every row a
    strip takes from a block is among them, zeros beyond the line's
    ends); copies, so the bits are the host forms'."""
    K, k = process_count(), process_index()
    L = x.shape[dim]
    T = min(G, L)
    got = peer_collective(torch.cat([x.narrow(dim, 0, T),
                                     x.narrow(dim, L - T, T)], dim=dim),
                          mem, GATHER)
    d = dim % x.dim()

    def piece(q, o, n):
        if q is None:
            shape = list(x.shape)
            shape[d] = n
            return x.new_zeros(shape)
        first = o if o + n <= T else T + o - (L - T)
        return got[q].narrow(d, first, n)

    def strip(a, e):
        return torch.cat([piece(q, o, n)
                          for q, _, o, n in _frame_pieces(a, e, G, L, K,
                                                          None)],
                         dim=d)

    return (strip(k * L, k * L + G),
            strip(k * L + G + L, k * L + 2 * G + L))


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
    """A partial sum (a 0-d tensor, or a tensor summed elementwise) summed
    over the blocks in block order, ``((t_0 + t_1) + t_2) + …``: the same
    operations on the same values on every block, so every block holds
    the same bits (PCG's step sizes and the stop tests read them), in a
    card group, across processes and in the mesh alike. Under
    ``device_collectives`` one launch of the peer collective kernel on
    the card; else the host collectives (``_psum_host``)."""
    if process_count() == 1:
        return t
    mem = _device_form(t, t.numel() * t.element_size())
    if mem is not None:
        return peer_collective(t, mem, SUM)
    return _psum_host(t)


def slab_total(part: torch.Tensor) -> torch.Tensor:
    """The sum over every slab of every block of ``part``, this block's
    (D/P,) per-slab partial sums: each block puts its partials at its
    slabs' places of a zero (D,) vector and ``psum`` adds the vectors
    (every entry one block's value plus zeros, so exact), so every block,
    and one block alone, sums the same vector: the same bits for any
    number of blocks."""
    P = process_count()
    if P == 1:
        return part.sum()
    Dl, k = part.shape[0], process_index()
    return psum(F.pad(part, (k * Dl, (P - 1 - k) * Dl))).sum()


def _psum_host(t: torch.Tensor) -> torch.Tensor:
    """``psum`` through the host collectives: every block's partial
    (``_gather_host``) added in block order. The plain version of the
    peer collective kernel's sum."""
    parts = _gather_host(t)
    total = parts[0]
    for q in range(1, parts.shape[0]):
        total = total + parts[q]
    return total


def _gather_host(x: torch.Tensor) -> torch.Tensor:
    """Every block's ``x`` in block order, (N, *x.shape) for the N =
    ``process_count()`` blocks, through the host collectives: copies in a
    card group (``_pull``), ``all_gather`` across processes; in the mesh
    the lead gathers its K blocks', ``all_gather`` exchanges them, and
    every block copies the whole. The plain version of the peer
    collective kernel's gather."""
    g = _group()
    if g is None:
        return _all_gather(x[None])
    K, k = g.size, _here.block
    parts = _pull(x, [(q, _identity) for q in range(K)]
                  if k == 0 or not _mesh() else [])
    if not _mesh():
        return torch.stack(parts)
    whole = x[None]
    if k == 0:
        whole = _all_gather(torch.stack(parts))
    return _pull(whole, [(0, _identity)])[0]


def all_gather_slabs(x: torch.Tensor) -> torch.Tensor:
    """(D/P, ...) local slabs -> the (D, ...) slabs of every block, in
    slab order: the peer collective kernel's gather under
    ``device_collectives``, else the host collectives (``_gather_host``).
    """
    if process_count() == 1:
        return x
    mem = _device_form(x, x.numel() * x.element_size())
    whole = (peer_collective(x, mem, GATHER) if mem is not None
             else _gather_host(x))
    return whole.reshape(-1, *x.shape[1:])


def _all_gather(x: torch.Tensor) -> torch.Tensor:
    w = _to_wire(x)
    parts = [torch.empty_like(w) for _ in range(world_size())]
    dist.all_gather(parts, w)
    return torch.cat(parts).to(x.device)


# ---------------------------------------------------------------------------
# Card memory other blocks address: K7's peer form, the peer collectives'.


class _CudaBytes:
    """``nbytes`` bytes of card memory at ``ptr``, for ``torch.as_tensor``
    (``__cuda_array_interface__``); the memory stays its owner's."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "strides": None, "version": 3}


@dataclasses.dataclass
class PeerMemory:
    """One allocation of this block's card (block ``block`` of the mesh)
    that other blocks address: ``local`` its bytes as a tensor, ``peers``
    the allocations of the same size of the blocks it reaches, by block,
    as this card reaches them (mapped through CUDA IPC when the block is
    another process's, its own pointer when it is a block of this
    process's card group), ``mapped`` those of them that are IPC
    mappings; ``above`` and ``below`` the line neighbours' (0 beyond the
    line's ends). ``free_peer_buffers`` releases it."""

    local: torch.Tensor
    peers: dict
    base: int
    device: int
    block: int
    mapped: tuple = ()

    @property
    def above(self) -> int:
        return self.peers.get(self.block - 1, 0)

    @property
    def below(self) -> int:
        return self.peers.get(self.block + 1, 0)


def peer_buffers(nbytes: int, reach=None) -> PeerMemory:
    """Collective: every block calls it with the same ``nbytes`` and
    ``reach``. Each makes a zeroed ``cudaMalloc`` of its own on its
    current card (not a block of PyTorch's caching allocator: an IPC
    handle names a whole allocation, and the memory must outlive the
    streams' reuse) and reaches the allocations of the blocks in
    ``reach`` (None: its line neighbours p-1 and p+1, K7's peer form;
    every block: the peer collectives'). A block of this process's card
    group is reached by its pointer, with peer access when it lies on
    another card; one in another process by mapping its allocation, whose
    64-byte CUDA IPC handle goes round once (``all_gather_object``; in
    the mesh the lead sends its group's handles). A handle that two
    blocks of one card open maps once, counted (CUDA's rule for a handle
    opened twice in one context). Raises if a step fails; there is no
    other path."""
    P = process_count()
    if P < 2:
        raise RuntimeError("peer_buffers needs a process group or a card "
                           "group of two or more blocks")
    lib = library()
    dev = torch.cuda.current_device()
    base = ctypes.c_void_p()
    r = process_index()
    g = _group()
    K = g.size if g is not None else 1
    handle = ctypes.create_string_buffer(64)
    if world_size() > 1:
        check(lib.amg_ipc_alloc(dev, nbytes, ctypes.byref(base), handle),
              "amg_ipc_alloc")
    else:
        check(lib.amg_peer_alloc(dev, nbytes, ctypes.byref(base)),
              "amg_peer_alloc")
    mine = (dev, base.value, handle.raw)
    group = g.exchange(mine) if g is not None else [mine]
    handles = None
    if world_size() > 1:
        if g is None or _here.block == 0:
            handles = [None] * world_size()
            dist.all_gather_object(handles, [h for _, _, h in group])
        if g is not None:
            handles = g.exchange(handles)[0]
    peers, mapped = {}, []
    for q in (r - 1, r + 1) if reach is None else reach:
        if q == r or not 0 <= q < P:
            continue
        if q // K == r // K:                # a block of this card group
            q_dev, ptr, _ = group[q % K]
            if q_dev != dev:
                check(lib.amg_peer_enable(dev, q_dev),
                      f"amg_peer_enable (card {dev} to card {q_dev})")
            peers[q] = ptr
        else:                               # a block of another process
            ptr = ctypes.c_void_p()
            check(lib.amg_ipc_open(dev, handles[q // K][q % K],
                                   ctypes.byref(ptr)),
                  f"amg_ipc_open (block {q}'s memory, process {q // K})")
            peers[q] = ptr.value
            mapped.append(ptr.value)
    local = torch.as_tensor(_CudaBytes(base.value, nbytes),
                            device=f"cuda:{dev}")
    return PeerMemory(local, peers, base.value, dev, r, tuple(mapped))


def free_peer_buffers(mems) -> None:
    """Collective: wait for this block's card; unmap the other processes'
    allocations mapped here; wait for every block of the mesh to have
    done the same (``barrier(processes=True)``), so no launch that writes
    this block's memory and no mapping of it is left; then free this
    block's. The ``local`` tensors must not be used after."""
    lib = library()
    torch.cuda.synchronize()
    for m in mems:
        for ptr in m.mapped:
            check(lib.amg_ipc_close(m.device, ptr), "amg_ipc_close")
        m.mapped = ()
    barrier(processes=True)
    for m in mems:
        m.peers = {}
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


# ---------------------------------------------------------------------------
# The collectives on the card, inside the loop graphs: the peer collective
# kernel (ops/kernels/peer_collective.py).


def barrier(processes: bool = False) -> None:
    """Collective in a card thread: wait until every block of the group
    has come here (nothing in one block). With ``processes``, every
    block of the mesh: then, under a process group, the process group's
    barrier (the lead's, in the mesh; nccl's on this process's card,
    named) and the group's again."""
    g = _group()
    if g is not None:
        g.exchange(None)
    if processes and world_size() > 1:
        if g is None or _here.block == 0:
            dist.barrier(**({"device_ids": [torch.cuda.current_device()]}
                            if dist.get_backend() == "nccl" else {}))
        if g is not None:
            g.exchange(None)


class GroupCollectives:
    """One block's memory for the peer collective kernel, made by every
    block of the mesh together (its N = ``process_count()`` blocks: the
    threads of a card group, the processes of a process group, or both;
    N <= ``MAX_BLOCKS``): an allocation of this block's card that every
    other block addresses (by pointer in its card group, through a CUDA
    IPC mapping from another process; ``peer_buffers``), slots of ``cap``
    bytes for each block by epoch parity, a flag a block and chunk, the
    epoch counter; ``status`` the host words a timed-out wait writes
    (after ``timeout_s``; None: ``peer_collective.TIMEOUT_S``). A payload
    larger than ``cap`` makes every block open a larger allocation
    together, outside a capture (the earlier ones stay, for the graphs
    that hold them, until ``close``)."""

    def __init__(self, cap: int = 1 << 20, timeout_s: float | None = None):
        N = process_count()
        if N > _pc.MAX_BLOCKS:
            raise ValueError(f"the peer collectives run over at most "
                             f"{_pc.MAX_BLOCKS} blocks, not {N}")
        if N < 2:
            raise RuntimeError("the peer collectives run over two or more "
                               "blocks: a card group, a process group, or "
                               "both")
        self.K, self.k = N, process_index()
        self.status = torch.zeros(2, dtype=torch.int32, pin_memory=True)
        self._timed_out = (ctypes.c_int * 2).from_address(
            self.status.data_ptr())
        self.timeout_s = _pc.TIMEOUT_S if timeout_s is None else timeout_s
        self.cap, self.call, self._mems = 0, None, []
        self._open(cap)

    @staticmethod
    def nbytes(K: int, cap: int) -> int:
        """One block's allocation: the slots, the flags, the counter
        (csrc/peer_collective.cu)."""
        return 2 * K * cap + 4 * (K * (cap // _pc.CHUNK) + 2)

    def _open(self, cap: int) -> None:
        """Collective: every block allocates and reaches every other
        block's allocation (``peer_buffers``)."""
        cap = -(-cap // _pc.CHUNK) * _pc.CHUNK
        mem = peer_buffers(self.nbytes(self.K, cap), reach=range(self.K))
        self._mems.append(mem)
        self.cap = cap
        bases = [mem.base if q == self.k else mem.peers[q]
                 for q in range(self.K)]
        self.call = _pc.call_template(self.K, self.k, cap, bases,
                                      self.status, self.timeout_s)

    def ensure(self, nbytes: int) -> None:
        """Room for a payload of ``nbytes`` (every block asks the same at
        the same call; collective when it grows)."""
        if nbytes <= self.cap:
            return
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"a collective of {nbytes} bytes while capturing, over the "
                f"{self.cap} bytes opened: run the piece once before its "
                f"capture")
        self._open(max(nbytes, 2 * self.cap))

    def check(self) -> None:
        """Raise if a wait of this block timed out: another block did not
        put its payload in time."""
        if self._timed_out[0]:
            raise RuntimeError(
                f"peer collective: a wait for another block's payload "
                f"timed out (epoch {self._timed_out[1]}); that block "
                f"stopped or fell behind by more than the bound")

    def close(self) -> None:
        """Collective: after this block's card work, unmap the other
        processes' allocations, wait for every block of the mesh, and
        free the allocations (``free_peer_buffers``)."""
        mems, self._mems, self.cap = self._mems, [], 0
        free_peer_buffers(mems)


@contextlib.contextmanager
def device_collectives(mem: "GroupCollectives | None"):
    """Within the block, on this thread, ``psum``, ``all_gather_slabs`` and
    ``edges`` of card tensors are the peer collective kernel on ``mem``
    (the loop graphs' pieces; ``mem`` None: no change)."""
    before = getattr(_here, "collectives", None)
    _here.collectives = mem if mem is not None else before
    try:
        yield
    finally:
        _here.collectives = before


@contextlib.contextmanager
def sizing_collectives(mem: "GroupCollectives | None"):
    """Within the block, on this thread, the collectives take the host
    form and K7 its plain version, and ``mem`` grows to hold each
    payload: the loop graphs' warm-ups, which run every piece once, so
    that no kernel of one block waits for another block's while a thread
    makes the allocations a first run makes (an allocation, or a library
    handle, can wait for the whole card)."""
    before = getattr(_here, "sizing", None)
    _here.sizing = mem
    try:
        yield
    finally:
        _here.sizing = before


def warming() -> bool:
    """True inside ``sizing_collectives``."""
    return getattr(_here, "sizing", None) is not None


def _device_form(t: torch.Tensor, nbytes: int):
    """The block's GroupCollectives when ``t``'s collective (a payload of
    ``nbytes``) runs on the card (``device_collectives``, a card tensor);
    under ``sizing_collectives`` None, after the memory has grown to hold
    it."""
    if not t.is_cuda:
        return None
    sizing = getattr(_here, "sizing", None)
    if sizing is not None:
        sizing.ensure(nbytes)
        return None
    return getattr(_here, "collectives", None)
