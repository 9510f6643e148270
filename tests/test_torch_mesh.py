"""amg_tpu_torch's distributed solvers on a mesh of P processes x K blocks
on the CPU (JAX's multi-host mesh): 2 gloo processes, each driving a card
group of 2 CPU blocks (``device=("cpu", "cpu")`` under a process group,
parallel/launch.py), so 4 blocks in all, block p·K + k the thread k of
process p.

The cases are tests/test_torch_multiprocess.py's ``runs()`` (10 f64
V-cycles of DistStructuredSolver under "sweep", "step", "rdma", "rdma" at
63^2 on 4 slabs, "sweep" on the jump problem's variable levels; of
EllDistSolver under "step" and "strips"; a few PCG iterations), each held
to the same solver in one block: the exchanges are copies and only the
order of the sums differs (each block's partial over its slabs, then
the 4 partials in block order), so rtol 1e-12, PCG 1e-10; "rdma" gives
"sweep"'s field bitwise. On D = 8 slabs of 31^2 a block holds 2 slabs of
4 rows and the strips of G = 10 rows cross the process boundary in
several hops;
``launch.frame`` is also held bitwise to the zero-padded line at strips
deeper than a process's whole line. Then amg_tpu's
``DistStructuredSolver(31, n_devices=4)`` against the mesh (one slab a
block), the device rule under a process group, and a block that raises
in process 1, which makes process 0 raise within a bound. The
collectives' plain versions over the 4 blocks: psum in block order (the
K partials gathered, then the processes', then added in block order on
every block), the peer collective kernel's CPU branch, and the edge
strips from one gather over the mesh (``launch._edges_device``, no
lead's frame) against the zero-framed line.

Each worker is this file run as a script:

    python tests/test_torch_mesh.py RANK WORLD PORT OUT_DIR [fail]
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_multiprocess import (ORDER_VALUES, RTOL,  # noqa
                                     RTOL_PCG, _free_port, runs)

P, K = 2, 2
BLOCKS = ("cpu",) * K
JAX_SIDE, JAX_SLABS, JAX_CYCLES = 31, 4, 10
FRAME_G = (1, 3, 7, 13, 30)      # rows a strip: within a block to past
FRAME_ROWS = 3                   # rows a block in the frame check
TIMEOUT = 240                    # seconds, for the workers of one run
FAIL_BOUND_S = 60.0              # process 0 raises within this


def _frame_checks(launch, torch) -> dict:
    """launch.frame on every block of the mesh against the zero-padded
    line of all 4 blocks, bitwise, for strips within a block up to deeper
    than the whole line; and launch.psum / all_gather_slabs."""
    from amg_tpu_torch.ops.kernels import peer_collective as pc

    n = P * K * FRAME_ROWS
    line = torch.arange(n * 3, dtype=torch.float64).reshape(n, 3) + 1.0
    group = launch.CardGroup(BLOCKS)

    def block(k):
        r = launch.process_index()
        x = line[r * FRAME_ROWS:(r + 1) * FRAME_ROWS].clone()
        ok = []
        for G in FRAME_G:
            want = torch.nn.functional.pad(line, (0, 0, G, G))[
                r * FRAME_ROWS:r * FRAME_ROWS + FRAME_ROWS + 2 * G]
            ok.append(bool(torch.equal(launch.frame(x, G, dim=0), want)))
        total = launch.psum(x.sum())
        whole = launch.all_gather_slabs(x)
        t = torch.tensor(ORDER_VALUES[r], dtype=torch.float64)
        order = launch.psum(t)
        edges = []
        for G in FRAME_G:
            pad = torch.nn.functional.pad(line, (0, 0, G, G))
            a = r * FRAME_ROWS
            got = launch._edges_device(x, G, 0, None)
            edges.append(bool(
                torch.equal(got[0], pad[a:a + G])
                and torch.equal(got[1], pad[a + G + FRAME_ROWS:
                                            a + 2 * G + FRAME_ROWS])))
        return dict(frame=ok, psum=float(total),
                    gathered=bool(torch.equal(whole, line)),
                    ids=[launch.process_count(), r, launch.world_size(),
                         launch.world_rank()],
                    order=float(order),
                    kernel_sum=bool(torch.equal(
                        pc.peer_collective(t, None, pc.SUM), order)),
                    kernel_gather=bool(torch.equal(
                        pc.peer_collective(x, None, pc.GATHER).reshape(-1, 3),
                        line)),
                    edges_device=edges)
    try:
        return group.run(block)
    finally:
        group.close()


def worker(rank: int, world: int, port: int, out_dir: str,
           fail: bool = False) -> None:
    import torch

    from amg_tpu_torch.models import poisson
    from amg_tpu_torch.parallel import launch
    from amg_tpu_torch.parallel.structured_dist import DistStructuredSolver

    torch.set_num_threads(1)
    info = launch.initialize_distributed(f"localhost:{port}", world, rank,
                                         local_devices=K)
    assert info == dict(process_index=rank, process_count=world,
                        local_devices=K, global_devices=world * K), info
    assert torch.distributed.get_backend() == "gloo"
    if fail:
        return _fail(rank, launch, DistStructuredSolver, poisson, out_dir)
    facts = {"info": info, "blocks": _frame_checks(launch, torch),
             "slab_devices": [launch.slab_devices(None, BLOCKS)[0],
                              launch.slab_devices(8, BLOCKS)[0]]}
    try:
        launch.slab_devices(6, BLOCKS)
    except ValueError as exc:
        facts["six_slabs"] = str(exc)
    out = {}
    for name, (make, case) in runs(BLOCKS).items():
        s = make()
        try:
            out[name + "_rss"], out[name + "_u"] = s.run(case)
            if name == "dist_sweep":
                facts["local_slabs"] = s._group.run(
                    lambda k: list(s._blocks[k].mesh.local_slabs))
        finally:
            s.close()
    b = poisson.rhs(JAX_SIDE, device="cpu").reshape(JAX_SIDE, JAX_SIDE)
    s = DistStructuredSolver(JAX_SIDE, n_devices=JAX_SLABS,
                             dtype=torch.float64, device=BLOCKS)
    try:
        res = s.solve(b, tolerance=0.0, compute_error_every_n_iters=1,
                      n_iters=JAX_CYCLES)
        facts["jax_case"] = dict(halo=s.cfg.halo, iterations=res.iterations,
                                 history=res.history)
        out["jax_u"] = res.u.numpy()
    finally:
        s.close()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(facts, f)
    torch.distributed.destroy_process_group()


def _fail(rank, launch, DistStructuredSolver, poisson, out_dir) -> None:
    """Block 1 of process 1 raises at its third psum, mid-solve; process
    1 then ends with the error. Process 0 records how long its solve took
    to raise, and what."""
    import torch

    real, calls = launch.psum, {}

    def psum(t):
        k = launch.process_index()
        calls[k] = calls.get(k, 0) + 1
        if k == 3 and calls[k] == 3:
            raise ArithmeticError("block 3 (process 1) fails mid-solve")
        return real(t)

    s = DistStructuredSolver(31, n_devices=8, dtype=torch.float64,
                             halo="sweep", device=BLOCKS)
    launch.psum = psum
    b2 = poisson.rhs(31, device="cpu").reshape(31, 31)
    t0 = time.monotonic()
    try:
        s.solve(b2, tolerance=0.0, compute_error_every_n_iters=1,
                n_iters=10)
        what = None
    except Exception as exc:            # noqa: BLE001 - reported below
        what = f"{type(exc).__name__}: {exc}"
        if rank == 1:
            raise
    with open(os.path.join(out_dir, f"fail{rank}.json"), "w") as f:
        json.dump({"seconds": time.monotonic() - t0, "error": what}, f)
    sys.stdout.flush()
    os._exit(0)         # the process group is broken: no orderly teardown


def _spawn(out_dir, *extra):
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank), str(P),
         str(port), str(out_dir), *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for rank in range(P)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"workers did not finish in {TIMEOUT} s")
    return procs, outs


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """Each rank's (arrays, facts) of the 2 x 2 mesh."""
    out_dir = tmp_path_factory.mktemp("mesh")
    procs, outs = _spawn(out_dir)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-3000:]}"
    got = []
    for rank in range(P):
        with open(out_dir / f"rank{rank}.json") as f:
            got.append((dict(np.load(out_dir / f"rank{rank}.npz")),
                        json.load(f)))
    return got


@pytest.fixture(scope="module")
def single():
    """Every case of runs() in one block, its arrays by name."""
    import torch

    torch.set_num_threads(1)
    out = {}
    for name, (make, case) in runs().items():
        s = make()
        out[name + "_rss"], out[name + "_u"] = s.run(case)
        if hasattr(s, "close"):
            s.close()
    return out


@pytest.mark.parametrize("case", sorted(runs()))
def test_mesh_matches_one_block(mesh, single, case):
    rtol = RTOL_PCG if "pcg" in case else RTOL
    for rank, (got, _) in enumerate(mesh):
        for what in ("rss", "u"):
            key = f"{case}_{what}"
            np.testing.assert_allclose(got[key], single[key], rtol=rtol,
                                       atol=0, err_msg=f"rank {rank} {key}")


def test_rdma_field_is_sweeps(mesh):
    """halo="rdma" on the mesh gives halo="sweep"'s field, bitwise, on
    every process: both exchange the strips by copies."""
    for rank, (got, _) in enumerate(mesh):
        np.testing.assert_array_equal(got["dist_rdma_u"],
                                      got["dist_sweep_u"],
                                      err_msg=f"rank {rank}")


def test_mesh_blocks_and_deep_strips(mesh):
    """Block p·K + k of 4, the process's rank and size kept apart; frame
    bitwise for strips within a block, across several blocks and deeper
    than the line; psum and all_gather_slabs over the 4 blocks; each
    block's slabs of D = 8."""
    line_sum = float(sum(range(1, P * K * 3 * 3 + 1)))
    for rank, (_, facts) in enumerate(mesh):
        assert facts["info"]["global_devices"] == P * K
        for k, blk in enumerate(facts["blocks"]):
            assert blk["ids"] == [P * K, rank * K + k, P, rank]
            assert blk["frame"] == [True] * len(FRAME_G), (rank, k)
            assert blk["psum"] == line_sum and blk["gathered"]
        slabs = 8 // (P * K)
        assert facts["local_slabs"] == [
            list(range((rank * K + k) * slabs, (rank * K + k + 1) * slabs))
            for k in range(K)]


def test_mesh_collectives_in_block_order(mesh):
    """Over the 4 blocks of the mesh psum is the block-order sum on every
    block, bitwise (1.0; another order gives 0 or 2), the peer collective
    kernel's CPU branch is that sum and the gather in block order, and the
    strips from one gather over the mesh are the zero-framed line's,
    bitwise, within a block up to deeper than the line."""
    want = ((ORDER_VALUES[0] + ORDER_VALUES[1]) + ORDER_VALUES[2]) \
        + ORDER_VALUES[3]
    assert want == 1.0
    for rank, (_, facts) in enumerate(mesh):
        for k, blk in enumerate(facts["blocks"]):
            assert blk["order"] == want, (rank, k)
            assert blk["kernel_sum"] and blk["kernel_gather"], (rank, k)
            assert blk["edges_device"] == [True] * len(FRAME_G), (rank, k)


def test_slab_devices_under_a_process_group(mesh):
    """A sequence of K devices under a process group of P is the
    process's K blocks of the mesh: one slab a block by default, and the
    slabs must split over all P·K blocks."""
    for _, facts in mesh:
        assert facts["slab_devices"] == [P * K, 8]
        assert "do not split" in facts["six_slabs"]
        assert "of each of 2 processes" in facts["six_slabs"]


def test_mesh_matches_jax_mesh(mesh):
    """amg_tpu's DistStructuredSolver(31, n_devices=4) on 4 virtual CPU
    devices (tests/conftest.py), one shard a device, against the port on
    the 2 x 2 mesh, one slab a block: 10 f64 V-cycles (the CPU default
    "step"), tests/test_torch_cards.py's rule: u within rtol 1e-12, each
    residual norm within 1e-12 of the first (the rss falls to where the
    last bits of u set it, and XLA orders the stencil sums otherwise)."""
    import jax.numpy as jnp

    from amg_tpu.models import poisson as jpoisson
    from amg_tpu.parallel import structured_dist as J

    side = JAX_SIDE
    b = np.asarray(jpoisson.rhs(side, dtype=jnp.float64)).reshape(side,
                                                                   side)
    jr = J.DistStructuredSolver(side, n_devices=JAX_SLABS, dtype=jnp.float64
                                ).solve(jnp.asarray(b), tolerance=0.0,
                                        compute_error_every_n_iters=1,
                                        n_iters=JAX_CYCLES)
    rj = np.sqrt([e for _, e in jr.history])
    for rank, (got, facts) in enumerate(mesh):
        case = facts["jax_case"]
        assert case["halo"] == "step"
        assert case["iterations"] == jr.iterations == JAX_CYCLES
        assert [i for i, _ in case["history"]] == [i for i, _ in jr.history]
        rt = np.sqrt([e for _, e in case["history"]])
        np.testing.assert_allclose(rt, rj, rtol=0, atol=1e-12 * rj[0])
        np.testing.assert_allclose(got["jax_u"], np.asarray(jr.u),
                                   rtol=1e-12, atol=0)


def test_a_failing_block_in_one_process_raises_in_the_other(tmp_path):
    """Block 3 (process 1's second) raises mid-solve: process 1 ends with
    its error, and process 0's solve raises within FAIL_BOUND_S instead
    of waiting for it."""
    procs, outs = _spawn(tmp_path, "fail")
    assert procs[1].returncode != 0
    assert "block 3 (process 1) fails mid-solve" in outs[1]
    assert procs[0].returncode == 0, outs[0][-3000:]
    with open(tmp_path / "fail0.json") as f:
        rec = json.load(f)
    assert rec["error"] is not None, rec
    assert rec["seconds"] < FAIL_BOUND_S, rec


if __name__ == "__main__":
    worker(*(int(a) for a in sys.argv[1:4]), sys.argv[4],
           fail=sys.argv[5:6] == ["fail"])
