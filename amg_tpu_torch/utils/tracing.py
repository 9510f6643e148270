"""The program's spans and counters: where a solve's time and work go,
from inside the program.

Counters, always on (nothing on the hot path: they are credited when the
counts are read). When a CUDA graph piece is captured
(``ops/kernels/graph_loop.py``), its nodes are counted by kind, child
graphs and conditional bodies included: the port's own kernels (K1-K12,
the condition kernel, the peer collective: the launches its wrappers
counted), other kernels (aten, cuBLAS, cuSOLVER: the plain ops), memcpy,
memset, other nodes, and the tracing stamps below as their own kind.
Each run of a piece adds its counts, read off the graph's device counts
(``LoopGraph.execs``) when they are settled; each replay of a loop
program is one solve. ``report()["counters"]``.

Spans, off by default, switched on for the whole process by
:func:`enable` (``disable``, ``reset``, ``report``). A span has a name,
attributes, a start, an end and a parent; its self time is its time less
the time its children cover. ``with span(name, **attrs)`` at a layer
boundary is:

* tracing off: a flag check; nothing is recorded, launched or captured;
* inside a CUDA graph capture on the traced card: two stamps, one-thread
  kernels (``trace_stamp``, ``csrc/graph_loop.cu``) that write (span,
  begin or end, ``%globaltimer``) into a device ring at an atomic index.
  They are nodes of the captured piece, so a graph's conditional (WHILE)
  body, which CUPTI does not record, carries its own timings; a stamp
  that finds the ring full is dropped and counted;
* anywhere else (the host driver, the CPU): a host span on
  ``time.perf_counter_ns``, so CPU runs see the same tree.

Set-up spans (:func:`setup_span`: ``setup.hierarchy``, with
``setup.galerkin_planes`` inside it for a plane operator,
``setup.kernels``, ``setup.capture``, ``setup.warm_solve``, the ELL
hierarchy's phases) are host spans that are always timed: their sums by name
(``report()["setup"]``) are kept for the process, tracing on or off, and
``reset`` leaves them; while tracing is on they are recorded as spans
too.

Device stamps are put on the host's clock through calibration stamps
taken at ``enable``, ``reset`` and ``report``: eager stamps bracketed by
host reads, the tightest bracket of several kept. :func:`chrome_events`
gives the spans as Chrome trace events (``utils/profiling.trace`` adds
them to its ``trace.json``, aligned to the profiler's clock through
CUPTI's records of calibration stamps launched under it). Spans and
counts stay in memory until ``report`` is called.
"""

from __future__ import annotations

import contextlib
import itertools
import statistics
import threading
import time
from collections import Counter
from types import SimpleNamespace

import torch

# kinds of graph nodes the counters keep
KINDS = ("kernel_own", "kernel_other", "stamp", "memcpy", "memset", "other")
# cudaGraphNodeType values (driver_types.h); a child graph or a
# conditional node is walked into, not counted
_KERNEL, _MEMCPY, _MEMSET, _CHILD, _CONDITIONAL = 0, 1, 2, 4, 13
# device stamps the ring holds (16 bytes each, 64 MiB): a 4095^2 solve
# stamps about 700 times, a 32 s window of them some 250,000
RING_STAMPS = 1 << 22
# eager stamps a calibration takes, the tightest bracket kept
CALIBRATIONS = 8


class Count:
    """A count that a captured piece's tally holds and that each run of
    the piece adds to (``_build.credit``), as a kernel wrapper's
    ``launches``."""

    def __init__(self, name: str):
        self.__name__ = name
        self.launches = 0


NODES = {k: Count(f"nodes.{k}") for k in KINDS}
SOLVES = Count("solves")
# masked V-cycles (structured.cycle_stencil), by the level kinds that ran
# them (on CPU tensors the kernels' wrappers run their plain twins): those
# of the masked legs K10/K11, and the runs of other masked levels
MASKED_CYCLES = {k: Count(f"masked_cycles.{k}") for k in ("kernel", "plain")}
# visits of the levels without constant weights (a variable-coefficient
# hierarchy's; the coarsest level's LU excluded): those of a sweep kernel's
# kind (K6 on the fused_var levels, K12 on the masked_k12 ones), and those
# of the plain ops (masked, packed-var, strided, Chebyshev)
VAR_LEVELS = {k: Count(f"var_levels.{k}") for k in ("kernel", "plain")}
# visits of the constant packed levels (structured.vcycle_packed): those
# whose sweeps and transfers a fused kernel took (the kinds legs, split and
# sweep: K1-K3, K8), and those of the plain packed ops (the kind packed)
PACKED_LEVELS = {k: Count(f"packed_levels.{k}") for k in ("kernel", "plain")}

_COUNT_LOCK = threading.Lock()
_SETUP: Counter = Counter()         # set-up seconds by span name, always
_TRACER = None                      # the state while tracing is on
_TLS = threading.local()            # this thread's open host spans, track
_OFF = contextlib.nullcontext()


def census(tally: Counter, types) -> None:
    """Add to a captured piece's ``tally`` its nodes by kind: ``types`` are
    the piece's node types (``graph_loop.node_types``), the tally already
    holds the kernel launches the wrappers counted while it was captured
    (the port's own kernels) and the stamps; every other kernel node is
    another's (aten, cuBLAS, cuSOLVER)."""
    t = Counter(types)
    stamps = tally[NODES["stamp"]]
    own = sum(n for c, n in tally.items() if not isinstance(c, Count))
    tally[NODES["kernel_own"]] += own
    tally[NODES["kernel_other"]] += t[_KERNEL] - own - stamps
    tally[NODES["memcpy"]] += t[_MEMCPY]
    tally[NODES["memset"]] += t[_MEMSET]
    tally[NODES["other"]] += sum(
        n for k, n in t.items()
        if k not in (_KERNEL, _MEMCPY, _MEMSET, _CHILD, _CONDITIONAL))


def credit_solves(solves: int, conditions: int) -> None:
    """Add a loop graph's settled replays (solves) and the condition
    kernel's runs (the port's own kernel nodes of the graph's frame)."""
    with _COUNT_LOCK:
        SOLVES.launches += solves
        NODES["kernel_own"].launches += conditions


def counters() -> dict:
    """The counts since the last ``reset``, as they stand (``report``
    settles the graphs first): kernel nodes executed (the stamps
    excluded), by kind, the solves, the masked V-cycles by machinery
    (``masked_cycles_kernel``: K10/K11 pairs; ``masked_cycles_plain``:
    runs of masked levels in plain ops, one a cycle that reaches them),
    the visits of variable-coefficient levels by machinery
    (``var_levels_kernel``: swept by K6 or K12; ``var_levels_plain``: by
    the plain ops), and the visits of constant packed levels by machinery
    (``packed_levels_kernel``: fused kernels; ``packed_levels_plain``: the
    plain packed ops)."""
    n = {k: c.launches for k, c in NODES.items()}
    return {"kernels": n["kernel_own"] + n["kernel_other"],
            "kernels_own": n["kernel_own"],
            "kernels_other": n["kernel_other"], "stamps": n["stamp"],
            "memcpy": n["memcpy"], "memset": n["memset"],
            "other_nodes": n["other"], "solves": SOLVES.launches,
            "masked_cycles_kernel": MASKED_CYCLES["kernel"].launches,
            "masked_cycles_plain": MASKED_CYCLES["plain"].launches,
            "var_levels_kernel": VAR_LEVELS["kernel"].launches,
            "var_levels_plain": VAR_LEVELS["plain"].launches,
            "packed_levels_kernel": PACKED_LEVELS["kernel"].launches,
            "packed_levels_plain": PACKED_LEVELS["plain"].launches}


# -- the switch ---------------------------------------------------------------

# what the captured stamps refer to lives as long as the process: a graph
# captured while tracing was on keeps writing its stamps, into its card's
# ring and under its sites' numbers, after a disable or a new enable
_RINGS: dict = {}                   # card index -> (ring, its index/drops)
_SITES: dict = {}                   # (name, attributes) -> site number
_SITE_INFO: list = []               # site number -> (name, attributes)
_SITE_LOCK = threading.Lock()
_TRACKS = itertools.count(1)


def _site(name: str, attrs: dict) -> int:
    key = (name, tuple(sorted(attrs.items())))
    with _SITE_LOCK:
        s = _SITES.get(key)
        if s is None:
            s = _SITES[key] = len(_SITE_INFO)
            _SITE_INFO.append((name, dict(attrs)))
    return s


class _Tracer:
    """What tracing holds while it is on: the host spans finished since the
    last reset and, on a card, its ring and the calibrations."""

    def __init__(self, device):
        self.device = device
        self.lock = threading.Lock()
        self.host = []
        self.unpaired = 0
        self.ids = itertools.count()
        self.calibrations = []
        if device.type == "cuda":
            if device.index not in _RINGS:
                _RINGS[device.index] = (
                    torch.zeros((RING_STAMPS, 2), dtype=torch.int64,
                                device=device),
                    torch.zeros(2, dtype=torch.int32, device=device))
            self.ring, self.ctrl = _RINGS[device.index]
            self.ctrl.zero_()
            self.cal_ring = torch.zeros((CALIBRATIONS, 2), dtype=torch.int64,
                                        device=device)
            self.cal_ctrl = torch.zeros(2, dtype=torch.int32, device=device)

    def mode(self) -> str | None:
        """How a span begins or ends on this thread now: "stamp" while it
        captures a graph on the traced card, None while it captures one
        elsewhere (nothing is recorded), else "host"."""
        if not (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing()):
            return "host"
        if (self.device.type == "cuda"
                and torch.cuda.current_device() == self.device.index):
            return "stamp"
        return None


def enable(device=None) -> None:
    """Tracing on for the process, fresh (what an earlier ``enable``
    recorded is dropped). ``device``: the card whose captures take
    stamps (its ring, RING_STAMPS records, is made at the first enable
    for the card, before any capture, and kept for the process); None or
    a CPU device traces host spans only."""
    global _TRACER
    dev = torch.device("cpu") if device is None else torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    _TRACER = _Tracer(dev)
    _calibrate(_TRACER)


def disable() -> None:
    """Tracing off: spans are flag checks again; what was recorded is
    dropped. Graphs captured while it was on keep their stamps."""
    global _TRACER
    _TRACER = None


def enabled() -> bool:
    return _TRACER is not None


def reset() -> None:
    """Start a new reading: settle the graphs' counts, then zero the
    counters, drop the recorded spans, empty the ring and calibrate
    again. The set-up sums stay."""
    from amg_tpu_torch.ops.kernels import graph_loop
    graph_loop.settle()
    with _COUNT_LOCK:
        for c in (*NODES.values(), SOLVES, *MASKED_CYCLES.values(),
                  *VAR_LEVELS.values(), *PACKED_LEVELS.values()):
            c.launches = 0
    t = _TRACER
    if t is None:
        return
    with t.lock:
        t.host = []
        t.unpaired = 0
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
        t.ctrl.zero_()
        t.calibrations = []
        _calibrate(t)


def new_track() -> int:
    """A track for the stamps of one loop's captures (0 while tracing is
    off): a track's stamps pair up among themselves, so loops replayed on
    two streams at once keep their trees apart."""
    return 0 if _TRACER is None else next(_TRACKS)


@contextlib.contextmanager
def track(k: int):
    """Stamps captured in the block belong to track ``k``."""
    old = getattr(_TLS, "track", 0)
    _TLS.track = k
    try:
        yield
    finally:
        _TLS.track = old


# -- spans ----------------------------------------------------------------------

def _stack() -> list:
    s = getattr(_TLS, "stack", None)
    if s is None:
        s = _TLS.stack = []
    return s


def _open(t: _Tracer, name: str, attrs: dict) -> SimpleNamespace:
    stack = _stack()
    h = SimpleNamespace(name=name, attrs=attrs, id=next(t.ids),
                        parent=stack[-1].id if stack else None,
                        thread=threading.get_ident(),
                        start=time.perf_counter_ns(), end=None)
    stack.append(h)
    return h


def _close(t: _Tracer, h: SimpleNamespace, end_ns: int) -> None:
    """End host span ``h`` and any span opened inside it and left open (an
    exception went through them); one that is not open (opened before
    tracing was switched on) is counted as unpaired."""
    stack = _stack()
    if not any(x is h for x in stack):
        with t.lock:
            t.unpaired += 1
        return
    while True:
        x = stack.pop()
        x.end = end_ns
        with t.lock:
            t.host.append(x)
        if x is h:
            return


def _stamp(t: _Tracer, site: int, end: int) -> None:
    from amg_tpu_torch.ops.kernels import _build
    code = (getattr(_TLS, "track", 0) << 32) | (site << 1) | end
    _build.check(_build.library().amg_trace_stamp(
        t.ring.data_ptr(), t.ctrl.data_ptr(), RING_STAMPS, code,
        torch.cuda.current_stream(t.device).cuda_stream), "amg_trace_stamp")
    _build.count_launch(NODES["stamp"])


def begin(name: str, **attrs) -> None:
    """Open span ``name`` (see the module docstring); :func:`end` closes
    it, on the same thread, in the same mode: within one captured piece,
    or across the pieces a host driver runs in turn."""
    t = _TRACER
    if t is None:
        return
    mode = t.mode()
    if mode == "stamp":
        _stamp(t, _site(name, attrs), 0)
    elif mode == "host":
        _open(t, name, attrs)


def end(name: str) -> None:
    """Close the innermost open span, which must be ``name`` (a captured
    end stamp carries the name alone: the ring pairs it with the
    innermost begin of its track)."""
    t = _TRACER
    if t is None:
        return
    mode = t.mode()
    if mode == "stamp":
        _stamp(t, _site(name, {}), 1)
    elif mode == "host":
        open_ = [x for x in _stack() if x.name == name]
        h = open_[-1] if open_ else SimpleNamespace(name=name)
        _close(t, h, time.perf_counter_ns())


class _Span:
    __slots__ = ("name", "attrs")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        begin(self.name, **self.attrs)
        return self

    def __exit__(self, *exc):
        end(self.name)
        return False


def span(name: str, **attrs):
    """A context manager: the span ``name`` around the block (see the
    module docstring). Off: a flag check and a shared null context."""
    if _TRACER is None:
        return _OFF
    return _Span(name, attrs)


@contextlib.contextmanager
def setup_span(name: str, device=None, **attrs):
    """A set-up span: always timed, its seconds added to the set-up sum of
    ``name`` and yielded as ``.seconds`` after the block; a span too while
    tracing is on. With a CUDA ``device``, the block's work on it is
    waited for inside the span."""
    rec = SimpleNamespace(seconds=0.0)
    t = _TRACER
    h = _open(t, name, attrs) if t is not None else None
    t0 = time.perf_counter_ns() if h is None else h.start
    try:
        yield rec
    finally:
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter_ns()
        rec.seconds = (t1 - t0) * 1e-9
        with _COUNT_LOCK:
            _SETUP[name] += rec.seconds
        if h is not None:
            _close(t, h, t1)


def setup_seconds() -> dict:
    """Set-up seconds by span name, summed over the process."""
    with _COUNT_LOCK:
        return dict(_SETUP)


# -- the card's clock ---------------------------------------------------------

def _calibrate(t: _Tracer) -> list:
    """CALIBRATIONS eager stamps on the traced card, each between two host
    reads with the stream drained before and after; keeps the tightest
    bracket's (host middle, device time, bracket) and returns every
    stamp's device time."""
    if t.device.type != "cuda":
        return []
    from amg_tpu_torch.ops.kernels import _build
    lib = _build.library()
    stream = torch.cuda.current_stream(t.device)
    t.cal_ctrl.zero_()
    brackets = []
    for _ in range(CALIBRATIONS):
        stream.synchronize()
        h0 = time.perf_counter_ns()
        _build.check(lib.amg_trace_stamp(
            t.cal_ring.data_ptr(), t.cal_ctrl.data_ptr(), CALIBRATIONS, 0,
            stream.cuda_stream), "amg_trace_stamp")
        stream.synchronize()
        brackets.append((h0, time.perf_counter_ns()))
    dev = [int(x) for x in t.cal_ring[:, 1].tolist()]
    i = min(range(CALIBRATIONS), key=lambda k: brackets[k][1]
            - brackets[k][0])
    h0, h1 = brackets[i]
    t.calibrations.append(((h0 + h1) // 2, dev[i], h1 - h0))
    return dev


def calibration_stamps() -> list:
    """Take a calibration now (as ``reset`` does) and return its stamps'
    device times (ns): under a profiler, CUPTI records each as a
    ``trace_stamp`` kernel. Empty unless tracing is on for a card."""
    t = _TRACER
    return [] if t is None else _calibrate(t)


def _clock(t: _Tracer):
    """(device ns -> host ns, host ns -> device ns, the description): the
    tightest calibration's offset, and the rate between the first and the
    last calibrations when they lie a second or more apart."""
    cal = t.calibrations
    if not cal:
        return (lambda d: d), (lambda h: h), {}
    h_a, d_a, br = min(cal, key=lambda c: c[2])
    rate = 1.0
    if cal[-1][1] - cal[0][1] >= 10 ** 9:
        rate = (cal[-1][0] - cal[0][0]) / (cal[-1][1] - cal[0][1])
    return ((lambda d: h_a + (d - d_a) * rate),
            (lambda h: d_a + (h - h_a) / rate),
            {"offset_ns": h_a - d_a, "bracket_ns": br, "rate": rate,
             "calibrations": len(cal)})


def timer_resolution(device=None) -> tuple:
    """(least step, mean step) of the card's ``%globaltimer`` in ns, from
    one thread that reads it until it has changed 64 times."""
    from amg_tpu_torch.ops.kernels import _build
    dev = torch.device("cuda" if device is None else device)
    out = torch.zeros(2, dtype=torch.int64, device=dev)
    _build.check(_build.library().amg_timer_steps(
        out.data_ptr(), 64, torch.cuda.current_stream(dev).cuda_stream),
        "amg_timer_steps")
    least, whole = out.tolist()
    return int(least), whole / 64


# -- the reading ----------------------------------------------------------------

def _ring(t: _Tracer, to_host) -> tuple:
    """The device spans of the ring: stamps paired per track in ring order
    (one stream runs a track's pieces in turn), each span's parent the
    innermost span open at its begin. Returns (spans, recorded, dropped,
    unpaired)."""
    head, dropped = (int(x) for x in t.ctrl.tolist())
    n = min(head, RING_STAMPS)
    rec = t.ring[:n].tolist()
    spans, stacks, unpaired = [], {}, 0
    for code, ts in rec:
        trk, site, is_end = code >> 32, (code >> 1) & 0x7FFFFFFF, code & 1
        st = stacks.setdefault(trk, [])
        name, attrs = _SITE_INFO[site]
        if not is_end:
            spans.append({"name": name, "attrs": attrs, "where": "device",
                          "track": trk, "dev_start": ts, "dev_end": None,
                          "parent": st[-1] if st else None})
            st.append(len(spans) - 1)
        elif st and spans[st[-1]]["name"] == name:
            spans[st.pop()]["dev_end"] = ts
        else:
            unpaired += 1
    unpaired += sum(len(st) for st in stacks.values())
    keep = [i for i, s in enumerate(spans) if s["dev_end"] is not None]
    where = {i: k for k, i in enumerate(keep)}
    out = []
    for i in keep:
        s = spans[i]
        s["parent"] = where.get(s["parent"])
        s["start_ns"] = to_host(s["dev_start"])
        s["end_ns"] = to_host(s["dev_end"])
        out.append(s)
    return out, n, dropped, unpaired


def _self_times(spans: list) -> None:
    covered = [0] * len(spans)
    for s in spans:
        if s["parent"] is not None:
            covered[s["parent"]] += s["end_ns"] - s["start_ns"]
    for s, c in zip(spans, covered):
        s["self_ns"] = s["end_ns"] - s["start_ns"] - c


def report() -> dict:
    """The reading since the last ``reset`` (or ``enable``): settles the
    graphs' counts and waits for the traced card. ``counters``,
    ``setup`` (the process's set-up sums) and, while tracing is on,
    ``spans`` (host spans first, then the card's; each with ``name``,
    ``attrs``, ``where``, ``start_ns`` and ``end_ns`` on the host clock,
    ``self_ns``, ``parent``: an index into the list, or None),
    ``host_unpaired`` (host ends without a begin: spans opened before
    tracing was on), ``device`` and, on a card, ``stamps`` (recorded,
    dropped, unpaired) and ``clock``."""
    from amg_tpu_torch.ops.kernels import graph_loop
    graph_loop.settle()
    out = {"enabled": _TRACER is not None, "counters": counters(),
           "setup": setup_seconds(), "spans": []}
    t = _TRACER
    if t is None:
        return out
    with t.lock:
        host = list(t.host)
        out["host_unpaired"] = t.unpaired
    host.sort(key=lambda h: h.start)
    index = {h.id: i for i, h in enumerate(host)}
    spans = [{"name": h.name, "attrs": h.attrs, "where": "host",
              "thread": h.thread, "start_ns": h.start, "end_ns": h.end,
              "parent": index.get(h.parent)} for h in host]
    out["device"] = (torch.cuda.get_device_name(t.device)
                     if t.device.type == "cuda" else "cpu")
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
        _calibrate(t)
        to_host, _, clock = _clock(t)
        dev, recorded, dropped, unpaired = _ring(t, to_host)
        base = len(spans)
        for s in dev:
            if s["parent"] is not None:
                s["parent"] += base
        spans += dev
        out["stamps"] = {"recorded": recorded, "dropped": dropped,
                         "unpaired": unpaired}
        out["clock"] = clock
    _self_times(spans)
    out["spans"] = spans
    return out


def totals(rep: dict, where: str = "device", self_time: bool = False,
           pred=None) -> dict:
    """Seconds by span name in a ``report`` (``where``: "device" or
    "host"), the spans' whole time or their self time, of the spans that
    ``pred(span)`` accepts (all when None)."""
    key = "self_ns" if self_time else None
    out = Counter()
    for s in rep.get("spans", ()):
        if s["where"] != where or (pred is not None and not pred(s)):
            continue
        ns = s[key] if key else s["end_ns"] - s["start_ns"]
        out[s["name"]] += ns * 1e-9
    return dict(out)


def chrome_events(rep: dict | None = None, to_us=None,
                  pid: str = "amg_tpu_torch spans") -> list:
    """The spans of ``rep`` (a ``report()``; taken now when None) as
    Chrome trace events: complete events ("X") on a process of their own,
    a thread for the card's spans and one for each host thread's; ``ts``
    in µs, ``to_us(host ns)`` or the host clock's µs."""
    rep = report() if rep is None else rep
    if to_us is None:
        def to_us(ns):
            return ns / 1e3
    events = []
    for s in rep.get("spans", ()):
        tid = ("card" if s["where"] == "device"
               else f"host {s.get('thread', 0)}")
        args = dict(s["attrs"], self_us=s["self_ns"] / 1e3)
        start = to_us(s["start_ns"])
        events.append({"name": s["name"], "ph": "X", "pid": pid,
                       "tid": tid, "ts": start,
                       "dur": to_us(s["end_ns"]) - start, "args": args})
    return events


def profiler_clock(kernels: list, stamps: list):
    """host ns -> the profiler's µs, from CUPTI's records of calibration
    stamps: ``kernels`` the (start µs, end µs) of the ``trace_stamp``
    kernels the profiler recorded for ``stamps`` (their device times,
    ns), in the same order. Each pair gives an offset (the record's
    middle less its stamp); a line through them in the device time takes
    up the two clocks' drift. None without two pairs, or while tracing
    is off."""
    t = _TRACER
    if t is None or len(kernels) < 2 or len(kernels) != len(stamps):
        return None
    off = [(a + b) / 2 - d / 1e3 for (a, b), d in zip(kernels, stamps)]
    d0, o0 = statistics.fmean(stamps), statistics.fmean(off)
    var = sum((d - d0) ** 2 for d in stamps)
    slope = (sum((d - d0) * (o - o0) for d, o in zip(stamps, off)) / var
             if var else 0.0)
    _, to_dev, _ = _clock(t)

    def to_us(ns):
        d = to_dev(ns)
        return d / 1e3 + o0 + (d - d0) * slope
    return to_us
