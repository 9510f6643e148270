"""amg_tpu_torch's distributed solvers over a card group on the CPU: one
process, K blocks of the D = 8 row slabs, a thread a block
(parallel/launch.py ``CardGroup``; ``device=("cpu",) * K``), against the
same solvers in one block, and against amg_tpu's one-program mesh.

The cases are tests/test_torch_multiprocess.py's ``runs()``, the ones its
P gloo processes run: 10 f64 V-cycles of DistStructuredSolver (halo
"sweep", "step", "rdma", "rdma" at 63^2 on 4 slabs, "sweep" on the jump
problem's variable levels), of EllDistSolver ("step", "strips"), and a
few PCG iterations; each case runs on every block's thread
(``solver.run``). The exchanges between the blocks are copies, so the
V-cycle iterates are those of one block; only the order of the sums
differs (each block adds the blocks' partials in block order), so the
rss and the fields agree within rtol 1e-12, PCG (whose sums feed its
iterates) within 1e-10. On the CPU "rdma" runs K7's plain version, the
strip exchange of "sweep": its field is "sweep"'s, bitwise.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from amg_tpu.models import poisson as jpoisson
from amg_tpu.parallel import structured_dist as J

from amg_tpu_torch.models import poisson
from amg_tpu_torch.ops.kernels import _build
from amg_tpu_torch.parallel import launch
from amg_tpu_torch.parallel import structured_dist as T
from amg_tpu_torch.parallel.ell_dist import EllDistSolver

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_multiprocess import RTOL, RTOL_PCG, runs  # noqa: E402

torch.set_num_threads(1)
CASES = sorted(runs())
FAIL_BOUND_S = 30.0   # a failed block reaches the caller within this


def run_cases(device="cpu") -> dict:
    """Every case of runs(), its solvers built on ``device`` (one block on
    the CPU, or a sequence of blocks), run on every block (block 0's
    arrays)."""
    out = {}
    for name, (make, case) in runs(device).items():
        s = make()
        try:
            out[name] = s.run(case)
        finally:
            s.close()
    return out


@pytest.fixture(scope="module")
def single():
    return run_cases()


@pytest.fixture(scope="module", params=[2, 4])
def grouped(request):
    """(K, block 0's arrays of every case) on a group of K CPU blocks."""
    K = request.param
    return K, run_cases(("cpu",) * K)


@pytest.mark.parametrize("case", CASES)
def test_card_group_matches_one_block(grouped, single, case):
    K, got = grouped
    rtol = RTOL_PCG if "pcg" in case else RTOL
    for g, w, what in zip(got[case], single[case], ("rss", "u")):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=0,
                                   err_msg=f"{K} blocks, {case} {what}")


def test_rdma_field_is_sweeps(grouped):
    """halo="rdma" over the blocks gives halo="sweep"'s field, bitwise:
    both exchange the strips by copies."""
    K, got = grouped
    np.testing.assert_array_equal(got["dist_rdma"][1], got["dist_sweep"][1],
                                  err_msg=f"{K} blocks")


def test_card_group_matches_jax_mesh():
    """amg_tpu's DistStructuredSolver(31, n_devices=4) on 4 of the
    virtual CPU devices (tests/conftest.py), one shard a device, against
    the port on 4 CPU blocks, one slab a block: 10 f64 V-cycles (its CPU
    default "step"), the rss after each. u within rtol 1e-12. The rss
    falls to 6.6e-21, where it is set by the last bits of u (JAX's XLA
    orders the stencil sums otherwise than the port: one block gives the
    same differences), so each residual norm is held within 1e-12 of the
    first one."""
    side = 31
    b = np.asarray(jpoisson.rhs(side, dtype=jnp.float64)).reshape(side,
                                                                   side)
    kw = dict(tolerance=0.0, compute_error_every_n_iters=1, n_iters=10)
    jr = J.DistStructuredSolver(side, n_devices=4, dtype=jnp.float64
                                ).solve(jnp.asarray(b), **kw)
    s = T.DistStructuredSolver(side, n_devices=4, dtype=torch.float64,
                               device=("cpu",) * 4)
    try:
        tr = s.solve(b, **kw)
    finally:
        s.close()
    assert s.cfg.halo == "step" and len(s.devices) == 4
    assert tr.iterations == jr.iterations == 10
    assert [i for i, _ in tr.history] == [i for i, _ in jr.history]
    rt = np.sqrt([e for _, e in tr.history])
    rj = np.sqrt([e for _, e in jr.history])
    np.testing.assert_allclose(rt, rj, rtol=0, atol=1e-12 * rj[0])
    np.testing.assert_allclose(tr.u.numpy(), np.asarray(jr.u), rtol=1e-12,
                               atol=0)


@pytest.fixture
def cards(monkeypatch):
    """Pretend to see ``n`` cards: ``cards(n)``."""
    def see(n):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: n > 0)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    return see


def _cuda(*idx):
    return tuple(torch.device("cuda", i) for i in idx)


def test_device_rule(cards, monkeypatch):
    """launch.slab_devices, JAX's mesh over jax.devices()[:D]: with the
    default device the slabs spread over the largest number of the
    visible cards that divides D, consecutive slabs a card."""
    cards(4)
    assert launch.slab_devices(4, None) == (4, _cuda(0, 1, 2, 3))
    assert launch.slab_devices(None, None) == (4, _cuda(0, 1, 2, 3))
    assert launch.slab_devices(8, None) == (8, _cuda(0, 1, 2, 3))
    assert launch.slab_devices(6, None) == (6, _cuda(0, 1, 2))
    assert launch.slab_devices(7, None) == (7, (torch.device("cuda"),))
    # one explicit device keeps every slab there
    for dev in ("cuda", "cuda:1", "cpu"):
        assert launch.slab_devices(4, dev) == (4, (torch.device(dev),))
    cards(1)
    assert launch.slab_devices(4, None) == (4, (torch.device("cuda"),))
    assert launch.slab_devices(None, None) == (1, (torch.device("cuda"),))
    # a sequence: one block an entry
    seq = ("cuda:0", "cuda:0")
    assert launch.slab_devices(4, seq) == (4, (torch.device("cuda:0"),) * 2)
    assert launch.slab_devices(None, ("cpu",) * 4)[0] == 4
    with pytest.raises(ValueError, match="do not split"):
        launch.slab_devices(6, ("cpu",) * 4)
    cards(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.slab_devices(4, None)
    # P processes of K cards each is not built
    monkeypatch.setattr(launch, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="process group"):
        launch.slab_devices(4, ("cpu",) * 2)


def test_config_and_blocks():
    """MeshConfig.n_devices with a sequence of devices; each block holds
    its D/K consecutive slabs, and the slab-level methods run on a block
    (run), not on the group."""
    from amg_tpu_torch.config import MeshConfig

    s = T.DistStructuredSolver(31, config=MeshConfig(n_devices=8),
                               dtype=torch.float64, device=("cpu",) * 2)
    try:
        assert s.cfg.n_devices == 8 and s.devices == (torch.device("cpu"),) * 2
        assert s.run(lambda blk: list(blk.mesh.local_slabs)) == [0, 1, 2, 3]
        got = s._group.run(lambda k: list(s._blocks[k].mesh.local_slabs))
        assert got == [[0, 1, 2, 3], [4, 5, 6, 7]]
        with pytest.raises(RuntimeError, match="run"):
            s.pad_field(np.zeros((31, 31)))
    finally:
        s.close()
    A, b = poisson.poisson2d(35, device="cpu")
    e = EllDistSolver(A, b, 6, n_devices=4, device=("cpu",) * 2)
    try:
        with pytest.raises(RuntimeError, match="run"):
            e.pad_vec(e.b)
        assert e.run(lambda blk: blk.pad_vec(blk.b).shape) == (2, e.Bs[0])
    finally:
        e.close()


def test_a_failing_block_raises_in_the_caller(monkeypatch):
    """A block that raises mid-solve breaks the others' collectives: the
    caller gets its exception within a bounded time, the group takes no
    more work, and close() returns."""
    real, calls = launch.psum, {}

    def psum(t):
        k = launch.process_index()
        calls[k] = calls.get(k, 0) + 1
        if k == 1 and calls[k] == 3:
            raise ArithmeticError("block 1 fails mid-solve")
        return real(t)

    s = T.DistStructuredSolver(31, n_devices=8, dtype=torch.float64,
                               halo="sweep", device=("cpu",) * 4)
    monkeypatch.setattr(launch, "psum", psum)
    b2 = poisson.rhs(31, device="cpu").reshape(31, 31)
    t0 = time.monotonic()
    with pytest.raises(ArithmeticError, match="block 1"):
        s.solve(b2, tolerance=0.0, compute_error_every_n_iters=1,
                n_iters=10)
    assert time.monotonic() - t0 < FAIL_BOUND_S
    assert calls[1] == 3 and calls[0] >= 2
    with pytest.raises(RuntimeError, match="failed earlier"):
        s.solve(b2)
    group = s._group
    t0 = time.monotonic()
    s.close()
    assert time.monotonic() - t0 < FAIL_BOUND_S
    assert not any(t.is_alive() for t in group._threads)


def test_launch_counts_are_exact_under_threads():
    """count_launch from many threads at once, with a short switch
    interval: no increment is lost."""
    counter = _build.LaunchCounter("k")
    n_threads, n_each = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=lambda: [
            _build.count_launch(counter) for _ in range(n_each)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert counter.launches == n_threads * n_each
