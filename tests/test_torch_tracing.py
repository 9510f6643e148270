"""The program's spans and counters (``amg_tpu_torch/utils/tracing.py``)
on the CPU.

(a) The span tree of a solve under the host driver, for each solve loop:
    the entry point's host spans around the copy in, the launch and the
    clone out; under the launch one ``solve`` with its parts in the
    loop's order (start, a residual a pass, a refine a refining pass,
    the finish); ``vcycle.level`` spans under the start and the refines,
    nested level in level, with their level, side and machinery (the
    plan's kind of their level); every child inside its parent, self time
    its time less its children's.
(b) Tracing off records nothing and launches nothing: ``span`` is one
    shared null context, and a solve leaves no span.
(c) The counters: a piece's nodes by kind (``census``) times its runs
    from a loop graph's device counts (faked), the condition kernel and
    the solves; a dropped graph's last runs counted when it is destroyed.
(d) The ring's reading (``_ring``) on a ring written by hand: stamps
    paired per track in order, parents, drops and unpaired stamps; the
    clock's calibration; the Chrome events; the set-up sums that
    ``Hierarchy.setup_seconds`` keeps.
"""

import ctypes
import gc
from collections import Counter

import pytest
import torch

from amg_tpu_torch import StructuredSolver, multigrid, poisson, varcoef
from amg_tpu_torch.ops.kernels import graph_loop
from amg_tpu_torch.utils import tracing

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture
def traced():
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()


def _rhs(side):
    return poisson.rhs(side, device=CPU).reshape(side, side)


# (case, side, StructuredSolver options, plane operator): one of each
# loop, and the Kellogg cell's options
LOOPS = [("packed", 255, {}, None), ("unpacked", 63, {}, "jump"),
         ("f64", 63, {"precision": "f64"}, "jump"),
         ("kellogg", 63, {"smoother": "fused", "precision": "f64"},
          "kellogg")]


def _children(spans, i):
    return [j for j, s in enumerate(spans) if s["parent"] == i]


@pytest.mark.parametrize("case,side,kw,operator", LOOPS,
                         ids=[c[0] for c in LOOPS])
def test_solve_span_tree(traced, case, side, kw, operator):
    if operator:
        planes = getattr(varcoef, f"{operator}_planes")
        kw = dict(kw, A_planes=planes(side, device=CPU))
    s = StructuredSolver(side, device=CPU, **kw)
    tracing.reset()
    _, stats = s.solve_ir_device(_rhs(side), 1e-7)
    refines = int(stats[1])
    rep = tracing.report()
    spans = rep["spans"]
    assert rep["host_unpaired"] == 0
    assert all(x["where"] == "host" for x in spans)
    [entry] = [i for i, x in enumerate(spans)
               if x["name"] == "entry.solve_ir_device"]
    assert spans[entry]["parent"] is None
    kids = [spans[j]["name"] for j in _children(spans, entry)]
    assert kids == ["entry.copy_in", "entry.launch", "entry.clone_out"]
    launch = _children(spans, entry)[1]
    [solve] = _children(spans, launch)
    assert spans[solve]["name"] == "solve"
    parts = [spans[j]["name"] for j in _children(spans, solve)]
    # the packed loop refines only above the tolerance; the unpacked loops
    # refine on every pass, one past convergence
    passes = refines + 1 if case == "packed" else refines
    expect = ["solve.start"]
    for k in range(passes):
        expect.append("solve.residual")
        if case != "packed" or k < refines:
            expect.append("solve.refine")
    expect.append("solve.finish")
    assert parts == expect
    levels = [x for x in spans if x["name"] == "vcycle.level"]
    assert levels
    for x in levels:
        assert set(x["attrs"]) == {"level", "side", "machinery"}
        assert x["attrs"]["side"] == s.hier.sides[x["attrs"]["level"]]
        p = spans[x["parent"]]
        assert p["name"] in ("solve.start", "solve.refine", "vcycle.level")
        if p["name"] == "vcycle.level":
            # the level above, the level's own visit, or for the coarsest
            # level's LU the masked legs' entry
            assert (p["attrs"]["level"] in (x["attrs"]["level"] - 1,
                                            x["attrs"]["level"])
                    or p["attrs"]["machinery"] == "masked_legs"
                    and x["attrs"]["machinery"] == "coarse")
    # each visit names the machinery the plan gives its level
    for x in levels:
        kind = s.plan[x["attrs"]["level"]]
        assert x["attrs"]["machinery"] == ("coarse" if kind == "direct"
                                           else kind)
    machinery = {x["attrs"]["machinery"] for x in levels}
    assert "coarse" in machinery
    # the packed loop's 255^2 level takes the legs (K2/K3)
    assert machinery <= {"legs", "masked_legs", "masked_k12", "coarse"}
    assert ("legs" in machinery) == (case == "packed")
    for i, x in enumerate(spans):
        kids = _children(spans, i)
        assert all(x["start_ns"] <= spans[j]["start_ns"]
                   <= spans[j]["end_ns"] <= x["end_ns"] for j in kids)
        assert x["self_ns"] == (x["end_ns"] - x["start_ns"] - sum(
            spans[j]["end_ns"] - spans[j]["start_ns"] for j in kids))
        assert x["self_ns"] >= 0
    host = tracing.totals(rep, "host")
    self_ = tracing.totals(rep, "host", self_time=True)
    assert host["solve"] >= host["solve.start"] + host["solve.finish"]
    assert sum(self_.values()) == pytest.approx(
        host["entry.solve_ir_device"], rel=1e-9)


def test_fmg_visits_levels_down_and_up(traced):
    """The FMG start visits each level below the fine one twice (the b
    chain down, the prolongation and its cycle up) and the coarsest once;
    each up visit holds its level's cycle."""
    s = StructuredSolver(255, device=CPU)
    tracing.reset()
    s.solve_ir_device(_rhs(255), 1e-7)
    spans = tracing.report()["spans"]
    [start] = [i for i, x in enumerate(spans) if x["name"] == "solve.start"]
    top = [spans[j]["attrs"]["level"] for j in _children(spans, start)]
    L = s.hier.n_levels
    down = list(range(1, L - 1))
    assert top[:len(down) + 1] == down + [L - 1]
    up = top[len(down) + 1:]
    # then the fine level's packed V-cycle
    assert up == list(range(L - 2, 0, -1)) + [0]
    for j in _children(spans, start)[len(down) + 1:-1]:
        [cycle] = _children(spans, j)
        assert spans[cycle]["attrs"]["level"] == spans[j]["attrs"]["level"]


def test_off_records_and_launches_nothing(monkeypatch):
    tracing.disable()
    assert tracing.span("a") is tracing.span("b", level=1)
    before = tracing.NODES["stamp"].launches

    def no_stamp(*a, **k):
        raise AssertionError("a stamp while tracing is off")
    monkeypatch.setattr(tracing, "_stamp", no_stamp)
    s = StructuredSolver(255, device=CPU)
    s.solve_ir_device(_rhs(255), 1e-7)
    tracing.begin("x")
    tracing.end("y")                 # off: not checked, nothing kept
    rep = tracing.report()
    assert not rep["enabled"] and rep["spans"] == []
    assert tracing.NODES["stamp"].launches == before


def test_host_span_ends_in_order(traced):
    tracing.begin("outer")
    tracing.begin("inner")
    tracing.end("outer")             # ends the inner span it left open
    tracing.end("never")             # opened before tracing: counted
    rep = tracing.report()
    assert [x["name"] for x in rep["spans"]] == ["outer", "inner"]
    assert rep["spans"][1]["parent"] == 0
    assert rep["host_unpaired"] == 1


# -- the counters ---------------------------------------------------------------

class _Counter:
    __name__ = "toy"
    launches = 0


def _piece(own: int, other: int, stamps: int = 0, memcpy: int = 0):
    """A captured piece's tally after the census: ``own`` launches of a
    wrapper, node types of ``own + other + stamps`` kernels, a child
    graph node and a memcpy; with its stamps."""
    tally = Counter({_Counter(): own} if own else {})
    if stamps:
        tally[tracing.NODES["stamp"]] = stamps
    types = [0] * (own + other + stamps) + [4] + [1] * memcpy + [5]
    tracing.census(tally, types)
    return tally


def test_census_counts_nodes_by_kind():
    tally = _piece(3, 5, stamps=2, memcpy=1)
    n = {k: tally[c] for k, c in tracing.NODES.items()}
    assert n == {"kernel_own": 3, "kernel_other": 5, "stamp": 2,
                 "memcpy": 1, "memset": 0, "other": 1}


def _loop_graph(pieces, execs):
    g = graph_loop.LoopGraph.__new__(graph_loop.LoopGraph)
    g._pieces = pieces
    g._settled = [0, 0, 0, 0]
    g._exec = None
    g.execs = torch.tensor(execs)
    return g


def test_counters_are_nodes_times_runs():
    """Kernel nodes executed = each piece's kernel nodes times its runs
    (pre and post a replay, body a pass, refine a refining pass, final a
    recomputation) plus the condition kernel's runs; the stamps apart;
    a replay is a solve."""
    pieces = {"pre": (None, _piece(2, 40, stamps=6)),
              "post": (None, _piece(0, 3, stamps=2, memcpy=1)),
              "body": (None, _piece(1, 4, stamps=2)),
              "refine": (None, _piece(6, 90, stamps=60)),
              "final": ("captured", _piece(1, 4, stamps=2))}
    tracing.reset()
    g = _loop_graph(pieces, [2, 7, 5, 1])        # 2 solves
    g.settle()
    c = tracing.counters()
    conds = 2 + 7 + 2
    assert c["kernels_own"] == 2 * 2 + 0 + 7 * 1 + 5 * 6 + 1 * 1 + conds
    assert c["kernels_other"] == 2 * 40 + 2 * 3 + 7 * 4 + 5 * 90 + 4
    assert c["kernels"] == c["kernels_own"] + c["kernels_other"]
    assert c["stamps"] == 2 * 6 + 2 * 2 + 7 * 2 + 5 * 60 + 2
    assert c["memcpy"] == 2 and c["solves"] == 2
    g.settle()                                   # nothing new
    assert tracing.counters() == c
    tracing.reset()
    assert tracing.counters()["kernels"] == 0


def test_dropped_graph_keeps_its_last_runs():
    """A loop graph dropped before a settle: its runs since the last one
    are counted when the graph is destroyed (the next settle), then the
    graph is destroyed."""
    destroyed = []

    class Lib:
        @staticmethod
        def amg_loop_graph_destroy(graph, exec_):
            destroyed.append(exec_.value)
            return 0
    body = _Counter()
    pieces = {"pre": (None, _piece(0, 10)), "post": (None, Counter()),
              "body": (None, Counter({body: 1})),
              "refine": (None, Counter()), "final": (None, Counter())}
    tracing.reset()
    g = _loop_graph(pieces, [1, 3, 2, 0])
    g._lib, g._graph, g._exec = Lib(), ctypes.c_void_p(0), ctypes.c_void_p(7)
    g._launched_on = None
    g.settle()
    g.execs += torch.tensor([2, 6, 4, 0])         # two more solves, unsettled
    launches = body.launches
    del g
    gc.collect()
    graph_loop.settle()
    assert destroyed == [7]
    c = tracing.counters()
    assert c["solves"] == 3
    assert c["kernels_other"] == 3 * 10
    assert body.launches - launches == 6


# -- the ring, the clock, the exports -----------------------------------------

def _fake_ring(records, dropped=0):
    """A tracer on the CPU whose ring holds ``records``: (track, name,
    attrs, end, device ns)."""
    t = tracing._Tracer(CPU)
    t.ring = torch.zeros((len(records) + 4, 2), dtype=torch.int64)
    for i, (trk, name, attrs, end, ns) in enumerate(records):
        code = (trk << 32) | (tracing._site(name, attrs) << 1) | end
        t.ring[i] = torch.tensor([code, ns])
    t.ctrl = torch.tensor([len(records), dropped], dtype=torch.int32)
    return t


def test_ring_pairs_stamps_per_track(monkeypatch):
    monkeypatch.setattr(tracing, "RING_STAMPS", 64)
    lv = {"level": 1, "side": 7, "machinery": "masked"}
    t = _fake_ring([
        (1, "solve", {}, 0, 100), (2, "solve", {}, 0, 105),
        (1, "vcycle.level", lv, 0, 110), (1, "vcycle.level", {}, 1, 150),
        (2, "solve", {}, 1, 160), (1, "solve", {}, 1, 200),
        (1, "solve.refine", {}, 1, 210),         # an end with no begin
        (1, "solve", {}, 0, 300)], dropped=3)    # cut off by the drops
    spans, recorded, dropped, unpaired = t_ring = tracing._ring(
        t, lambda d: d + 1000)
    assert (recorded, dropped, unpaired) == (8, 3, 2), t_ring
    names = [(s["name"], s["track"]) for s in spans]
    assert names == [("solve", 1), ("solve", 2), ("vcycle.level", 1)]
    assert spans[2]["parent"] == 0 and spans[2]["attrs"] == lv
    assert spans[0]["parent"] is None and spans[1]["parent"] is None
    assert (spans[0]["start_ns"], spans[0]["end_ns"]) == (1100, 1200)
    tracing._self_times(spans)
    assert spans[0]["self_ns"] == 100 - 40


def test_clock_takes_the_tightest_bracket_and_the_rate():
    t = tracing._Tracer(CPU)
    t.calibrations = [(5_000, 1_000, 40), (6_000, 2_000, 10)]
    to_host, to_dev, desc = tracing._clock(t)
    assert desc["offset_ns"] == 4_000 and desc["rate"] == 1.0
    assert to_host(3_000) == 7_000 and to_dev(7_000) == 3_000
    t.calibrations = [(10, 0, 9), (2 * 10 ** 9 + 10, 10 ** 9, 5)]
    to_host, _, desc = tracing._clock(t)
    assert desc["rate"] == pytest.approx(2.0)
    assert to_host(10 ** 9 + 1) == pytest.approx(2 * 10 ** 9 + 12)


def test_profiler_clock_pairs_records_with_stamps(traced):
    """The offsets of the records' middles from their stamps, on a line
    in the device time: the profiler's clock 10 ppm fast here, the
    device clock the host's (no calibration on the CPU)."""
    stamps = [9_000, 10_000, 50_009_000, 50_010_000]     # ns, device
    kernels = [(d / 1e3 + 1.0 + d * 1e-8, d / 1e3 + 3.0 + d * 1e-8)
               for d in stamps]                          # µs, profiler
    to_us = tracing.profiler_clock(kernels, stamps)
    for d in (9_000, 25_000_000, 50_010_000):
        assert to_us(d) == pytest.approx(d / 1e3 + 2.0 + d * 1e-8)
    assert tracing.profiler_clock(kernels, stamps[:3]) is None
    assert tracing.profiler_clock(kernels[:1], stamps[:1]) is None


def test_chrome_events(traced):
    with tracing.span("outer", level=2):
        with tracing.span("inner"):
            pass
    ev = tracing.chrome_events(to_us=lambda ns: ns / 1e3 - 5)
    assert [e["name"] for e in ev] == ["outer", "inner"]
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in ev)
    assert ev[0]["args"]["level"] == 2 and "self_us" in ev[0]["args"]
    assert ev[0]["ts"] <= ev[1]["ts"]


def test_setup_seconds_are_the_spans_sums(traced):
    """``Hierarchy.setup_seconds``: the sums of the build's set-up spans,
    which tracing keeps by name for the process and records as spans
    while it is on."""
    before = tracing.setup_seconds()
    A, _ = poisson.poisson2d(15, device=CPU)
    h = multigrid.build_hierarchy(A, 3, device=CPU)
    after = tracing.setup_seconds()
    for k, v in h.setup_seconds.items():
        assert after[f"setup.{k}"] - before.get(f"setup.{k}", 0.0) \
            == pytest.approx(v, abs=1e-12)
    names = Counter(x["name"] for x in tracing.report()["spans"])
    assert names["setup.lu"] == 1 and names["setup.rap"] == 4


def test_setup_span_times_with_tracing_off():
    tracing.disable()
    before = tracing.setup_seconds().get("setup.test", 0.0)
    with tracing.setup_span("setup.test") as s:
        pass
    assert s.seconds >= 0.0
    assert tracing.setup_seconds()["setup.test"] == pytest.approx(
        before + s.seconds)
    assert tracing.report()["spans"] == []
