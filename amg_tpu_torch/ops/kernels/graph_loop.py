"""The device loop: JAX's ``lax.while_loop`` (and the ``lax.cond`` of the
packed solve loop) as one CUDA graph with device-side loop control
(``csrc/graph_loop.cu``).

A loop is given in JAX's cond/body form as a :class:`DeviceLoop`: pieces
that compute on device tensors only (no host read), and the loop state
``err`` (f64), ``tol`` (f64, the effective tolerance), ``it`` and ``n``
(int32), all 0-dim tensors the pieces read and write in place:

* ``body``: one pass; it writes ``err``;
* ``refine`` (optional): the correction of a pass, run only when ``err >
  tol`` (the packed loop's inner ``lax.cond``); without it ``body``
  refines on every pass;
* ``final`` (optional): run after the loop when ``err > tol`` (the packed
  loop's rss recomputation on budget exhaustion);
* per program, ``pre`` (the start, which sets ``err``, ``tol``, ``it``)
  and ``post`` (the outputs).

The loop control is :func:`loop_condition`; the condition kernel
``loop_condition`` of ``graph_loop.cu`` is its counterpart on the card,
where it sets the conditional nodes' handles. Two drivers run the same
pieces:

* :meth:`DeviceLoop.run_host`, the plain version: a Python loop that reads
  the condition on the host once a pass (the CPU's driver, and the
  oracle on the card);
* :meth:`DeviceLoop.graph`, the card's: every piece captured once by
  PyTorch (``torch.cuda.CUDAGraph(keep_graph=True)``, one memory pool),
  assembled as child graphs under a WHILE node (and IF nodes) and
  instantiated; :meth:`LoopGraph.launch` is one graph launch, with no host
  synchronization.

A program with no loop (JAX's jitted V-cycle, rss or one refine) is a
:class:`StraightGraph`: its one piece captured, ``launch()`` a replay.
JAX's host loop over a jitted chunk of cycles and a jitted rss is a
:class:`ChunkLoop`: a straight graph a chunk length and one for the rss,
the rss read between them.

Launch counts. The kernel wrappers count at capture into a tally of the
piece (``_build.capture_tally``), not into their counters; the graph
counts its replays, passes, refining passes and final recomputations on
the device, and :func:`settle` (called by ``launch_counts`` and
``reset_launch_counts``) adds each piece's tally times its runs to the
counters, and the condition kernel's own runs to
``loop_condition.launches``. A straight graph adds its tally at each
launch.

Threads. The blocks of a card group (``parallel/launch.py``) capture
and replay their own graphs, each on its own thread: every thread
captures on a stream of its own (``capture_stream``), one thread at a
time (``_CAPTURE_LOCK``); a memory pool is a loop's (so a block's). A
``barrier`` given to ``graph`` (every block of the mesh's: the card
group's, then the process group's) holds every block between its warm-up
and the captures and again before any replay, so no block waits in a
capture's device synchronization for another block's collective that
has not been launched, no block's first replay waits out another's
capture, and no other thread makes a CUDA call while one captures: the
captures keep CUDA's global capture mode.
In thread-local mode the coarsest level's ``torch.linalg.lu_solve``
captured stream-ordered allocation nodes, which a child graph cannot
hold (H100, driver 13.0, torch 2.11); in global mode, with cuSOLVER
(``structured.StencilHierarchy.coarse_solve``), it captures none.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
import weakref
from collections import Counter

import torch

from amg_tpu_torch.ops.kernels import _build, packed_df
from amg_tpu_torch.utils.debugging import check_rss

START, STEP, STEP_IF, FINAL = 0, 1, 2, 3


def loop_condition(err: torch.Tensor, tol: torch.Tensor, it: torch.Tensor,
                   n: torch.Tensor, mode: int):
    """The plain version of the condition kernel: returns ``(did, keep)``
    as 0-dim bool tensors and advances ``it`` in place. ``START``: keep =
    err > tol and it < n (JAX's first cond); ``STEP``: it += 1, then keep
    as at START (every pass refines); ``STEP_IF``: did = err > tol, it +=
    did, keep = did and it < n; ``FINAL``: did = err > tol (recompute the
    rss), keep unused. A NaN err compares false and ends the loop."""
    above = err > tol
    if mode == FINAL:
        return above, above
    if mode == STEP:
        it.add_(1)
    elif mode == STEP_IF:
        it.add_(above.to(it.dtype))
    return above, above & (it < n)


_LIVE = weakref.WeakSet()
_CAPTURE_STREAMS: dict = {}
# one capture at a time in the process: a card group's blocks take turns
_CAPTURE_LOCK = threading.RLock()
_SETTLE_LOCK = threading.Lock()


def capture_stream(dev: torch.device) -> torch.cuda.Stream:
    """The one stream of ``dev`` that every loop's pieces are warmed and
    captured on by this thread. A fresh stream per loop made cuBLAS
    capture stream-ordered allocation nodes (cudaMallocAsync) into the
    products of the second and later loops of a process (H100, driver
    13.0, torch 2.11), and a child graph cannot hold those; on the one
    stream it does not. Each thread (a card group's block) has its own,
    so two blocks on one card never capture on one stream."""
    key = (dev.index, threading.get_ident())
    s = _CAPTURE_STREAMS.get(key)
    if s is None:
        s = _CAPTURE_STREAMS[key] = torch.cuda.Stream(dev)
    return s


def _drop_capture_stream(stream: torch.cuda.Stream) -> None:
    for key, s in list(_CAPTURE_STREAMS.items()):
        if s is stream:
            del _CAPTURE_STREAMS[key]


_RETIRED: list = []


def settle() -> None:
    """Add the kernel launches of every live loop graph's replays since the
    last settle to the launch counters (reads each graph's device counts:
    waits for the streams it was launched on), and free the retired
    graphs. Call it where no card thread waits for this one."""
    with _SETTLE_LOCK:
        for g in list(_LIVE):
            g.settle()
        _free_retired()


def _free_retired() -> None:
    """Destroy the graphs that were dropped, after the work in flight on
    the stream each was last launched on (their captures' memory pool is
    released with them). Never called while a capture is underway. Left
    for later in a card group's thread (destroying a graph waits for the
    whole card, which could wait for another block's collective that
    waits for this thread) and under ``set_sync_debug_mode`` (the caller
    asked for no waits)."""
    from amg_tpu_torch.parallel import launch
    if launch.in_card_group() or not _RETIRED or \
            torch.cuda.get_sync_debug_mode():
        return
    while True:
        try:
            stream, free = _RETIRED.pop()
        except IndexError:
            return
        if stream is not None:
            stream.synchronize()
        free()


def node_types(graph: int) -> list:
    """The node types (cudaGraphNodeType values) of a captured graph."""
    types = (ctypes.c_int * 4096)()
    count = ctypes.c_int(0)
    _build.check(_build.library().amg_graph_node_types(
        graph, types, 4096, ctypes.byref(count)), "amg_graph_node_types")
    return list(types[:min(count.value, 4096)])


def versions() -> tuple[int, int]:
    """(driver, runtime) CUDA versions of the kernel library, 12030 =
    12.3."""
    d, r = ctypes.c_int(0), ctypes.c_int(0)
    _build.check(_build.library().amg_cuda_versions(ctypes.byref(d),
                                                    ctypes.byref(r)),
                 "amg_cuda_versions")
    return d.value, r.value


class _Capturer:
    """Warm-up and capture of pieces on this thread's capture stream of
    ``dev``, into one memory pool, with K4's ticket counter of their own
    (made before any capture)."""

    def __init__(self, dev: torch.device):
        self.stream = capture_stream(dev)
        self.pool = torch.cuda.graph_pool_handle()
        self.k4 = packed_df.new_counter(dev)
        self.dev = dev

    def warm(self, fns, ctx=None) -> None:
        """Run each piece once, eagerly, on the capture stream: builds the
        kernels, creates the library handles and fills the allocator
        before anything is captured; inside ``ctx()`` when given (a card
        group's: the host collectives)."""
        self.stream.wait_stream(torch.cuda.current_stream())
        with packed_df.stream_counter(self.dev, self.stream.cuda_stream,
                                      self.k4), \
                (ctx() if ctx is not None else contextlib.nullcontext()), \
                torch.cuda.stream(self.stream):
            for fn in fns:
                if fn is not None:
                    fn()
        torch.cuda.current_stream().wait_stream(self.stream)

    def capture(self, fn):
        g = torch.cuda.CUDAGraph(keep_graph=True)
        try:
            with packed_df.stream_counter(self.dev, self.stream.cuda_stream,
                                          self.k4), \
                    _build.capture_tally() as tally, \
                    torch.cuda.graph(g, pool=self.pool, stream=self.stream):
                fn()
        except RuntimeError:
            # a failed capture may leave the stream unusable: the next
            # loop takes a new one
            _drop_capture_stream(self.stream)
            raise
        return g, tally


@contextlib.contextmanager
def _in_turn(barrier):
    """The captures of every block of a card group: all warmed first
    (``barrier``), one thread at a time, then all captured before any
    replays (``barrier`` again)."""
    if barrier is not None:
        torch.cuda.current_stream().synchronize()
        barrier()
    with _CAPTURE_LOCK:
        yield
    if barrier is not None:
        barrier()


class StraightGraph:
    """A program with no loop control (a V-cycle, an rss, one refine of
    JAX's host-stepped loops): ``fn`` captured once after one eager run,
    ``launch()`` one replay on the current stream, with no host
    synchronization. ``launches`` counts them."""

    def __init__(self, fn, dev: torch.device, barrier=None, warm=None):
        if dev.type != "cuda":
            raise ValueError(f"StraightGraph: a CUDA graph runs on a CUDA "
                             f"device, not {dev}")
        _free_retired()
        cap = _Capturer(dev)
        cap.warm((fn,), warm)
        with _in_turn(barrier):
            self._graph, self._tally = cap.capture(fn)
            # here, not at the first replay: instantiating can wait for
            # the card, which another block's collectives may hold
            self._graph.instantiate()
        torch.cuda.current_stream().wait_stream(cap.stream)
        self.launches = 0
        self._launched_on = None

    def launch(self) -> None:
        self._launched_on = torch.cuda.current_stream()
        self._graph.replay()
        _build.credit(self._tally, 1)
        self.launches += 1

    def __del__(self):
        # retired, as LoopGraph's: destroyed by the next capture or count
        # read, after its last replay
        g = getattr(self, "_graph", None)
        if g is not None:
            _RETIRED.append((self._launched_on, lambda: g.reset()))


class ChunkLoop:
    """JAX's host loop over a jitted chunk of ``k`` cycles between two
    reads of the rss (``multigrid.solve``, ``structured.solve_stencil``):
    ``cycle(u, b)`` and ``rss(u, b)`` on the fixed buffers ``u`` and
    ``b`` (made like ``u_like`` and ``b_like``; a caller's tensor is
    copied in, never aliased), the rss into the 0-dim f64 ``err``. Two
    drivers run the same pieces: the host's (each piece run eagerly) and,
    on the card, one :class:`StraightGraph` a distinct ``k`` (a solve
    takes at most two: the check interval and the remainder) and one for
    the rss, each captured at its first use and kept for the next
    solves. Whoever holds the loop holds its graphs; dropping it retires
    them."""

    def __init__(self, cycle, rss, u_like: torch.Tensor,
                 b_like: torch.Tensor):
        self.cycle, self._rss_of = cycle, rss
        self.u = torch.zeros_like(u_like)
        self.b = torch.zeros_like(b_like)
        self.err = torch.zeros((), dtype=torch.float64, device=u_like.device)
        self.graphs = {}            # "rss" and each k: StraightGraph

    def _chunk(self, k: int):
        def run():
            u = self.u
            for _ in range(k):
                u = self.cycle(u, self.b)
            self.u.copy_(u)
        return run

    def _rss(self) -> None:
        self.err.copy_(self._rss_of(self.u, self.b))

    def _go(self, key, fn, host: bool) -> None:
        """One run of the piece: eagerly under the host driver, else one
        launch of its graph, captured first if it is new (the capture's
        warm-up runs the piece once, so the buffers are kept across it)."""
        if host:
            fn()
            return
        g = self.graphs.get(key)
        if g is None:
            keep = self.u.clone()
            g = self.graphs[key] = StraightGraph(fn, self.u.device)
            self.u.copy_(keep)
        g.launch()

    def solve(self, u0: torch.Tensor, b: torch.Tensor, tolerance: float,
              every: int, n_iters: int, host: bool, report=None):
        """The reference's stopping rule (multigrid.hpp:311-337) from
        ``u0``: chunks of cycles while ``it < n_iters and error >
        tolerance``, the rss read every ``every`` cycles (0: never; one
        read a check, ``report(it, error)`` after it). Returns (u, a new
        tensor; cycles; the last rss read, else the sentinel 100;
        history)."""
        self.u.copy_(u0)
        self.b.copy_(b)
        it, error, history = 0, 100.0, []
        while it < n_iters and error > tolerance:
            k = (min(every - (it % every), n_iters - it) if every
                 and every > 0 else n_iters - it)
            self._go(k, self._chunk(k), host)
            it += k
            if every and it % every == 0:
                self._go("rss", self._rss, host)
                error = check_rss(float(self.err))
                history.append((it, error))
                if report is not None:
                    report(it, error)
        return self.u.clone(), it, error, history


class DeviceLoop:
    """A loop in cond/body form on device tensors (see the module
    docstring); ``refine`` and ``final`` may be None."""

    def __init__(self, body, refine=None, final=None, *, err, tol, it, n):
        for name, t, dtype in (("err", err, torch.float64),
                               ("tol", tol, torch.float64),
                               ("it", it, torch.int32),
                               ("n", n, torch.int32)):
            if t.dtype != dtype or t.dim() != 0:
                raise TypeError(f"DeviceLoop: {name} must be a 0-dim "
                                f"{dtype} tensor")
        self.body, self.refine, self.final = body, refine, final
        self.err, self.tol, self.it, self.n = err, tol, it, n
        self._captured = None     # (body, refine, final) graphs and tallies
        self._cap = None

    def __del__(self):
        # retired, as the graphs made of them: destroyed later, where no
        # capture is underway and no card thread waits
        if getattr(self, "_captured", None):
            _RETIRED.append((None, self._captured.clear))

    def _cond(self, mode: int) -> tuple[bool, bool]:
        did, keep = loop_condition(self.err, self.tol, self.it, self.n, mode)
        return tuple(torch.stack([did, keep]).tolist())

    def run_host(self, pre, post) -> None:
        """The plain driver: ``pre``, the loop with one host read of the
        condition a pass, the final branch, ``post``."""
        pre()
        _, keep = self._cond(START)
        while keep:
            self.body()
            did, keep = self._cond(STEP_IF if self.refine else STEP)
            if self.refine is not None and did:
                self.refine()
        if self.final is not None and self._cond(FINAL)[0]:
            self.final()
        post()

    # -- the card ------------------------------------------------------------

    def graph(self, pre, post, barrier=None, warm=None) -> "LoopGraph":
        """Capture (the loop's pieces once, ``pre`` and ``post`` for this
        program) and instantiate the program's graph. CUDA only; raises
        with the driver's version if the driver refuses a conditional node
        or the capture fails. ``barrier``: a card group's, for the blocks
        that capture together (see the module docstring); ``warm``: a
        context the warm-up runs in."""
        dev = self.err.device
        if dev.type != "cuda":
            raise ValueError(f"DeviceLoop.graph: the loop graph runs on a "
                             f"CUDA device, not {dev}")
        lib = _build.library()
        _free_retired()
        first = self._captured is None
        if first:
            self._cap = _Capturer(dev)
            self._cap.warm((pre, self.body, self.refine, self.final, post),
                           warm)
        else:
            self._cap.warm((pre, post), warm)
        cap = self._cap
        with _in_turn(barrier):
            if first:
                self._captured = {k: (cap.capture(fn) if fn is not None
                                      else (None, Counter()))
                                  for k, fn in (("body", self.body),
                                                ("refine", self.refine),
                                                ("final", self.final))}
            pieces = dict(self._captured)
            pieces["pre"] = cap.capture(pre)
            pieces["post"] = cap.capture(post)
            graph = LoopGraph(self, pieces, lib, cap.stream)
        torch.cuda.current_stream().wait_stream(cap.stream)
        return graph


class LoopGraph:
    """One instantiated loop program (made by :meth:`DeviceLoop.graph`):
    ``launch()`` replays it on the current stream, one graph launch;
    ``launches`` counts them on the host, ``execs`` the replays, passes,
    refining passes and final recomputations on the device."""

    def __init__(self, loop: DeviceLoop, pieces: dict, lib, stream):
        dev = loop.err.device
        self._loop = loop
        self._pieces = pieces                 # keeps the captures alive
        self._lib = lib
        self._dev = dev
        self._launched_on = None
        self.execs = torch.zeros(4, dtype=torch.int64, device=dev)
        self._settled = [0, 0, 0, 0]
        self.launches = 0
        self._graph = ctypes.c_void_p()
        self._exec = ctypes.c_void_p()

        def raw(k):
            g = pieces[k][0]
            return None if g is None else g.raw_cuda_graph()

        stage = ctypes.c_int(0)
        err = lib.amg_loop_graph(
            dev.index, raw("pre"), raw("body"), raw("refine"), raw("final"),
            raw("post"), loop.err.data_ptr(), loop.tol.data_ptr(),
            loop.it.data_ptr(), loop.n.data_ptr(), self.execs.data_ptr(),
            stream.cuda_stream, ctypes.byref(self._graph),
            ctypes.byref(self._exec), ctypes.byref(stage))
        if err != 0:
            drv, rt = versions()
            kinds = {k: sorted(set(node_types(raw(k))))
                     for k in pieces if pieces[k][0] is not None}
            raise RuntimeError(
                f"amg_loop_graph: CUDA error {err} at step {stage.value} "
                f"(driver {drv}, runtime {rt}; conditional nodes need "
                f"12030 in both; the pieces' node types {kinds})")
        _LIVE.add(self)

    def launch(self) -> None:
        """Replay on the current stream; returns at once."""
        with torch.cuda.device(self._dev):
            self._launched_on = torch.cuda.current_stream(self._dev)
            _build.check(self._lib.amg_loop_graph_launch(
                self._exec, self._launched_on.cuda_stream),
                "amg_loop_graph_launch")
        self.launches += 1

    def settle(self) -> None:
        stream = getattr(self, "_launched_on", None)
        if stream is not None:
            stream.synchronize()
        now = self.execs.tolist()
        d = [a - b for a, b in zip(now, self._settled)]
        self._settled = now
        if not any(d):
            return
        p = self._pieces
        runs = {"pre": d[0], "post": d[0], "body": d[1], "refine": d[2],
                "final": d[3]}
        for k, n in runs.items():
            _build.credit(p[k][1], n)
        conds = d[0] + d[1] + (d[0] if p["final"][0] is not None else 0)
        _build.credit(Counter({loop_condition: 1}), conds)

    def __del__(self):
        # retired, not destroyed: the garbage collector may run this while
        # another graph is being captured, where waiting for the replays
        # in flight would end that capture
        if getattr(self, "_exec", None) is not None and self._exec.value:
            lib, graph, exec_ = self._lib, self._graph, self._exec
            pieces = [self._pieces]

            def free():
                lib.amg_loop_graph_destroy(graph, exec_)
                pieces.clear()
            _RETIRED.append((getattr(self, "_launched_on", None), free))


loop_condition.launches = 0
