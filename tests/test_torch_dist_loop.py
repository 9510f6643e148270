"""DistStructuredSolver's programs in cond/body form on the CPU, where the
host driver runs them (the card's graphs run the same pieces:
tests/test_torch_cuda.py, chip_smoke.py ``dist_graph_solves``).

* the drivers: "host" on the CPU, "graph" refused there;
* each loop's host driver bitwise against the host loop it replaced
  (restated here from the solver's own steps): JAX's ``_pcg_device``
  (err = dot(r0, r0) at the start, every pass refines) and
  ``_solve_device`` (err starts at inf, the rss lags one refine, the
  final rss recomputed);
* a card group of 2 and 4 CPU blocks (a thread each) bitwise against one
  block for ``solve_ir_fused``, ``solve_pcg`` and ``solve``, under every
  halo mode;
* the peer collective kernel's plain version (the card group's host
  collectives) against launch.py's collectives, bitwise, the sums in
  block order, and the edge strips assembled from a gather
  (``launch._edges_device``) against ``launch._edges_group``, one and
  several hops;
* a wait of the peer collectives that timed out (its status word set)
  raising in the solve that read the program's results.
"""

import ctypes

import numpy as np
import pytest
import torch

from amg_tpu_torch.models import poisson
from amg_tpu_torch.ops.doublefloat import DF32, df_add_f32
from amg_tpu_torch.ops.kernels import peer_collective as pc
from amg_tpu_torch.parallel import launch
from amg_tpu_torch.parallel import structured_dist as T

torch.set_num_threads(1)
CPU = torch.device("cpu")
SIDE, D = 63, 8


def _b2():
    return poisson.rhs(SIDE, device="cpu").reshape(SIDE, SIDE)


def test_drivers_on_the_cpu():
    s = T.DistStructuredSolver(31, n_devices=4, device=CPU)
    assert s.driver == "host"
    with pytest.raises(ValueError, match="graph driver"):
        T.DistStructuredSolver(31, n_devices=4, device=CPU, driver="graph")
    with pytest.raises(ValueError, match="unknown driver"):
        s.set_driver("device")
    s.set_driver("host")
    assert s.driver == "host"


def _old_pcg(s, b2, tol, n_iters):
    """The host loop the PCG program replaced: one read of the rss a
    pass."""
    b = s.pad_field(b2)
    tol = float(torch.tensor(tol, dtype=b.dtype))

    def precond(r):
        return -s._vcycle_raw(torch.zeros_like(r), r)
    r = -b
    z = precond(r)
    u, p, rz = torch.zeros_like(b), z, s._dot(r, z)
    err, it = s._dot(r, r), 0
    while float(err) > tol and it < n_iters:
        u, r, z, p, rz = T._step(lambda x: -s._matvec(x), precond, u, r, z,
                                 p, rz, dot=s._dot)
        err = s._dot(r, r)
        it += 1
    return u, float(err), it


def _old_ir(s, b2, tol, n_refine):
    """The host loop the solve_ir_device program replaced."""
    b_df = s._split_b(b2)
    u = DF32.from_f32(torch.zeros_like(b_df.hi))
    err, it = float("inf"), 0
    while err > tol and it < n_refine:
        r = s._residual(b_df, u)
        err = float(s._rss_df(r))
        u = df_add_f32(u, s._cycles(r.hi))
        it += 1
    return u, float(s._rss_df(s._residual(b_df, u))), it


@pytest.mark.parametrize("halo", ["rdma", "step"])
def test_loops_bitwise_the_host_loops_they_replaced(halo):
    b2 = _b2()
    s = T.DistStructuredSolver(SIDE, n_devices=D, halo=halo, device=CPU)
    for n in (100, 2):                     # converged, and out of budget
        u, stats = s.solve_pcg_device(b2.float(), 1e-5, n)
        ou, oerr, oit = _old_pcg(s, b2.float(), 1e-5, n)
        assert torch.equal(u, ou)
        assert stats.tolist() == [oerr, float(oit)]
        uh, ul, st = s.solve_ir_device(b2, 1e-9, n)
        ou, oerr, oit = _old_ir(s, b2, 1e-9, n)
        assert torch.equal(uh, ou.hi) and torch.equal(ul, ou.lo)
        assert st.tolist() == [oerr, float(oit)]
    assert oit == 2
    res = s.solve_ir_fused(b2, 1e-9)
    assert res.converged and res.iterations == 2 * _old_ir(s, b2, 1e-9,
                                                           40)[2]


def _runs(s, b2):
    out = {}
    for name, call in (
            ("fused", lambda: s.solve_ir_fused(b2, tolerance=1e-9)),
            ("pcg", lambda: s.solve_pcg(b2.float(), tolerance=1e-5)),
            ("solve", lambda: s.solve(b2, tolerance=1e-7,
                                      compute_error_every_n_iters=2))):
        r = call()
        out[name] = (r.u, r.iterations, r.error, r.history)
    return out


@pytest.mark.parametrize("halo", ["rdma", "sweep", "step"])
def test_card_group_bitwise_one_block(halo):
    """2 and 4 CPU blocks (D/K slabs each, a thread a block, the host
    collectives) give one block's u, counts and rss bitwise (31^2 on 8
    slabs)."""
    b2 = poisson.rhs(31, device="cpu").reshape(31, 31)
    one = _runs(T.DistStructuredSolver(31, n_devices=D, halo=halo,
                                       device=CPU), b2)
    for K in (2, 4):
        s = T.DistStructuredSolver(31, n_devices=D, halo=halo,
                                   device=("cpu",) * K)
        try:
            assert s.driver == "host"
            got = _runs(s, b2)
        finally:
            s.close()
        for name, (u, it, err, hist) in one.items():
            gu, git, gerr, ghist = got[name]
            assert torch.equal(gu, u), (K, name)
            assert (git, gerr, ghist) == (it, err, hist), (K, name)


def _group(K, fn):
    g = launch.CardGroup(("cpu",) * K)
    try:
        return g.run(fn)
    finally:
        g.close()


def test_plain_twin_against_the_host_collectives():
    """On CPU tensors the kernel's wrapper is the group's host
    collectives: the K partials added in block order (values whose sum
    depends on the order), the gather in block order, bitwise
    launch.psum and launch.all_gather_slabs."""
    K = 4
    vals = [1e16, 1.0, -1e16, 1.0]

    def block(k):
        t = torch.tensor(vals[k], dtype=torch.float64)
        x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * k
        return (pc.peer_collective(t, None, pc.SUM), launch.psum(t),
                pc.peer_collective(x, None, pc.GATHER),
                launch.all_gather_slabs(x))
    want = ((vals[0] + vals[1]) + vals[2]) + vals[3]
    assert want == 1.0 and sum(sorted(vals)) != want
    for s, p, g, a in _group(K, block):
        assert s.item() == want and torch.equal(s, p)
        assert torch.equal(g.reshape(2 * K, 3), a)
        assert torch.equal(g[2], torch.arange(6.).reshape(2, 3) + 20)
    with pytest.raises(ValueError, match="mode"):
        pc.peer_collective(torch.zeros(2), None, 7)


@pytest.mark.parametrize("K,L,G", [(2, 6, 1), (4, 6, 3), (4, 2, 5),
                                   (3, 4, 9)])
def test_edges_from_a_gather_bitwise_the_host_strips(K, L, G):
    """launch._edges_device (one gather of every block's first and last
    min(G, L) rows, then the block's pieces) against _edges_group (copies
    from the blocks that hold the rows), along dim 0 and along -2 of a
    batched field: one hop (G <= L) and several (G > L)."""
    def block(k):
        x = (torch.arange(L * 5, dtype=torch.float64).reshape(L, 5)
             + 100.0 * (k + 1))
        xb = torch.stack([x, -x])
        return (launch._edges_device(x, G, 0, None),
                launch._edges_group(x, G, 0),
                launch._edges_device(xb, G, -2, None),
                launch._edges_group(xb, G, -2))
    for k, (d0, g0, d2, g2) in enumerate(_group(K, block)):
        for a, b in ((d0, g0), (d2, g2)):
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), k
        if k == 0:
            assert not d0[0].any()           # the line's top end: zeros


class _Status:
    """The status words of launch.GroupCollectives without the card."""

    check = launch.GroupCollectives.check

    def __init__(self):
        self.status = torch.zeros(2, dtype=torch.int32)
        self._timed_out = (ctypes.c_int * 2).from_address(
            self.status.data_ptr())


def test_a_timed_out_wait_raises_in_the_solve():
    """A wait of the peer collectives that timed out writes 1 and its
    epoch into the status words; the solve that reads the program's
    results raises, on every block of the group."""
    st = _Status()
    st.check()
    st.status[0], st.status[1] = 1, 41
    with pytest.raises(RuntimeError, match="timed out .epoch 41"):
        st.check()
    s = T.DistStructuredSolver(31, n_devices=4, device=("cpu",) * 2)
    try:
        s.run(lambda blk: setattr(blk, "_coll", st))
        with pytest.raises(RuntimeError, match="peer collective: a wait"):
            s.solve_ir_fused(poisson.rhs(31, device="cpu").reshape(31, 31),
                             tolerance=1e-9)
    finally:
        s.close()
    assert np.array_equal(st.status.numpy(), [1, 41])
