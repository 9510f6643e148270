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

Launch counts. The kernel wrappers count at capture into a tally of the
piece (``_build.capture_tally``), not into their counters; the graph
counts its replays, passes, refining passes and final recomputations on
the device, and :func:`settle` (called by ``launch_counts`` and
``reset_launch_counts``) adds each piece's tally times its runs to the
counters, and the condition kernel's own runs to
``loop_condition.launches``.
"""

from __future__ import annotations

import ctypes
import weakref
from collections import Counter

import torch

from amg_tpu_torch.ops.kernels import _build, packed_df

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


def capture_stream(dev: torch.device) -> torch.cuda.Stream:
    """The one stream of ``dev`` that every loop's pieces are warmed and
    captured on. A fresh stream per loop made cuBLAS capture stream-ordered
    allocation nodes (cudaMallocAsync) into the products of the second
    and later loops of a process (H100, driver 13.0, torch 2.11), and a
    child graph cannot hold those; on the one stream it does not."""
    s = _CAPTURE_STREAMS.get(dev.index)
    if s is None:
        s = _CAPTURE_STREAMS[dev.index] = torch.cuda.Stream(dev)
    return s


_RETIRED: list = []


def settle() -> None:
    """Add the kernel launches of every live loop graph's replays since the
    last settle to the launch counters (reads each graph's device counts:
    waits for the graphs in flight), and free the retired graphs."""
    for g in list(_LIVE):
        g.settle()
    _free_retired()


def _free_retired() -> None:
    """Destroy the graphs that were dropped, after the work in flight
    (their captures' memory pool is released with them). Never called
    while a capture is underway: a device-wide wait would end it."""
    while _RETIRED:
        lib, graph, exec_, pieces, dev = _RETIRED.pop()
        torch.cuda.synchronize(dev)
        lib.amg_loop_graph_destroy(graph, exec_)
        del pieces


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
        self._stream = None
        self._pool = None
        self._k4 = None

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

    def _capture(self, fn):
        g = torch.cuda.CUDAGraph(keep_graph=True)
        try:
            with packed_df.stream_counter(self.err.device,
                                          self._stream.cuda_stream,
                                          self._k4), \
                    _build.capture_tally() as tally, \
                    torch.cuda.graph(g, pool=self._pool,
                                     stream=self._stream):
                fn()
        except RuntimeError:
            # a failed capture may leave the stream unusable: the next
            # loop takes a new one
            _CAPTURE_STREAMS.pop(self._stream.device.index, None)
            raise
        return g, tally

    def _warm(self, fns) -> None:
        """Run each piece once, eagerly, on the capture stream: builds the
        kernels, creates the library handles and fills the allocator
        before anything is captured."""
        self._stream.wait_stream(torch.cuda.current_stream())
        with packed_df.stream_counter(self.err.device,
                                      self._stream.cuda_stream, self._k4), \
                torch.cuda.stream(self._stream):
            for fn in fns:
                if fn is not None:
                    fn()
        torch.cuda.current_stream().wait_stream(self._stream)

    def graph(self, pre, post) -> "LoopGraph":
        """Capture (the loop's pieces once, ``pre`` and ``post`` for this
        program) and instantiate the program's graph. CUDA only; raises
        with the driver's version if the driver refuses a conditional node
        or the capture fails."""
        dev = self.err.device
        if dev.type != "cuda":
            raise ValueError(f"DeviceLoop.graph: the loop graph runs on a "
                             f"CUDA device, not {dev}")
        lib = _build.library()
        _free_retired()
        if self._captured is None:
            self._stream = capture_stream(dev)
            self._pool = torch.cuda.graph_pool_handle()
            self._k4 = packed_df.new_counter(dev)
            self._warm((pre, self.body, self.refine, self.final, post))
            self._captured = {k: (self._capture(fn) if fn is not None
                                  else (None, Counter()))
                              for k, fn in (("body", self.body),
                                            ("refine", self.refine),
                                            ("final", self.final))}
        else:
            self._warm((pre, post))
        pieces = dict(self._captured)
        pieces["pre"] = self._capture(pre)
        pieces["post"] = self._capture(post)
        torch.cuda.current_stream().wait_stream(self._stream)
        return LoopGraph(self, pieces, lib)


class LoopGraph:
    """One instantiated loop program (made by :meth:`DeviceLoop.graph`):
    ``launch()`` replays it on the current stream, one graph launch;
    ``launches`` counts them on the host, ``execs`` the replays, passes,
    refining passes and final recomputations on the device."""

    def __init__(self, loop: DeviceLoop, pieces: dict, lib):
        dev = loop.err.device
        self._loop = loop
        self._pieces = pieces                 # keeps the captures alive
        self._lib = lib
        self._dev = dev
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
            _build.stream_of(self.execs), ctypes.byref(self._graph),
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
            _build.check(self._lib.amg_loop_graph_launch(
                self._exec, _build.stream_of(self.execs)),
                "amg_loop_graph_launch")
        self.launches += 1

    def settle(self) -> None:
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
            _RETIRED.append((self._lib, self._graph, self._exec,
                             self._pieces, self._dev))


loop_condition.launches = 0
