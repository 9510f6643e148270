"""amg_tpu_torch's distributed solvers across processes on the CPU: P gloo
processes (parallel/launch.py), each holding D/P of the D = 8 row slabs,
against the same solvers in one process (whose V-cycles
tests/test_torch_dist*.py and tests/test_torch_ell_dist.py check against
amg_tpu).

Each worker is this file run as a script, one process a rank. It runs 10
f64 V-cycles of DistStructuredSolver (halo "sweep", "step" and "rdma" on
constant levels, "rdma" also at 63^2 on 4 slabs, whose fine slabs hold
the strip rows, "sweep" on the jump problem's variable levels) and of
EllDistSolver ("step" and "strips"), and a few PCG iterations, and writes
the rss after each V-cycle and the field it gathered from every process.
The exchanges are copies, so the V-cycle iterates are those of one
process; only the order of the sums differs (an all_reduce of the
processes' partial sums), so the rss and the fields agree within rtol
1e-12. PCG feeds its sums back into the iterates: rtol 1e-10. On the CPU
"rdma" runs K7's plain version, the strip exchange of "sweep": on every
rank its field is "sweep"'s, bitwise.

    python tests/test_torch_multiprocess.py RANK WORLD PORT OUT_DIR
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

D = 8
SIDE = 31
ELL_SIDE = 35
CYCLES = 10
PCG_ITERS = 4
RTOL = 1e-12
RTOL_PCG = 1e-10
TIMEOUT = 240       # seconds, for all the workers of one test


def runs(device="cpu"):
    """name -> (build the solver, run it): every case a worker runs, in
    one process or across the process group, whichever is current, its
    solvers on ``device`` (a sequence of devices: a card group,
    tests/test_torch_cards.py)."""
    import torch

    from amg_tpu_torch.models import poisson, varcoef
    from amg_tpu_torch.parallel.ell_dist import EllDistSolver
    from amg_tpu_torch.parallel.structured_dist import DistStructuredSolver

    b2 = poisson.rhs(SIDE, device="cpu").reshape(SIDE, SIDE)
    A, b = poisson.poisson2d(ELL_SIDE, device="cpu")

    def dist(side=SIDE, n_devices=D, **kw):
        return lambda: DistStructuredSolver(side, n_devices=n_devices,
                                            dtype=torch.float64,
                                            device=device, **kw)

    def ell(halo):
        return lambda: EllDistSolver(A, b, 6, n_devices=D, halo=halo,
                                     device=device)

    def cycles(s):
        bp = s.pad_field(poisson.rhs(s.side, device="cpu").reshape(
            s.side, s.side))
        u, rss = torch.zeros_like(bp), []
        for _ in range(CYCLES):
            u = s.vcycle(u, bp)
            rss.append(s.rss(u, bp))
        return np.array(rss), s.unpad(u).numpy()

    def ell_cycles(s):
        bp = s.pad_vec(s.b)
        u, rss = torch.zeros_like(bp), []
        for _ in range(CYCLES):
            u = s.vcycle_once(u, bp)
            rss.append(s.rss(u, bp))
        return np.array(rss), s.unpad_vec(u).numpy()

    def pcg(s):
        r = s.solve_pcg(b2, tolerance=0.0, n_iters=PCG_ITERS)
        return np.array([r.error, r.iterations]), r.u.numpy()

    def ell_pcg(s):
        r = s.solve_pcg(tolerance=0.0, n_iters=PCG_ITERS)
        return np.array([r.error, r.iterations]), r.u.numpy()

    return {
        "dist_sweep": (dist(halo="sweep"), cycles),
        "dist_step": (dist(halo="step"), cycles),
        "dist_rdma": (dist(halo="rdma"), cycles),
        # slabs of 16 rows >= G = 10 on the fine level: K7's exchange
        "dist_rdma_b16": (dist(halo="rdma", side=63, n_devices=4), cycles),
        "dist_var": (dist(halo="sweep", A_fine=varcoef.jump_scipy(SIDE)),
                     cycles),
        "dist_pcg": (dist(halo="sweep"), pcg),
        "ell_step": (ell("step"), ell_cycles),
        "ell_strips": (ell("strips"), ell_cycles),
        "ell_pcg": (ell("step"), ell_pcg),
    }


def run_all() -> dict:
    out = {}
    for name, (make, run) in runs().items():
        s = make()
        out[name + "_rss"], out[name + "_u"] = run(s)
        if hasattr(s, "close"):
            s.close()
    return out


def worker(rank: int, world: int, port: int, out_dir: str) -> None:
    import torch

    from amg_tpu_torch.parallel import launch

    torch.set_num_threads(1)
    info = launch.initialize_distributed(f"localhost:{port}", world, rank)
    assert info == dict(process_index=rank, process_count=world,
                        local_devices=1, global_devices=world), info
    assert torch.distributed.get_backend() == "gloo"
    mesh = launch.device_mesh_1d(D)
    assert list(mesh.local_slabs) == list(range(rank * D // world,
                                                (rank + 1) * D // world))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **run_all())
    torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def single():
    import torch

    torch.set_num_threads(1)
    return run_all()


@pytest.fixture(scope="module", params=[2, 4])
def workers(request, tmp_path_factory):
    """(nproc, each rank's arrays): the workers of one process group."""
    nproc = request.param
    out_dir = tmp_path_factory.mktemp(f"p{nproc}")
    port = _free_port()
    # the workers run on the CPU: with the cards hidden the backend is gloo
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank), str(nproc),
         str(port), str(out_dir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for rank in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"workers did not finish in {TIMEOUT} s")
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-3000:]}"
    return nproc, [dict(np.load(out_dir / f"rank{rank}.npz"))
                   for rank in range(nproc)]


def test_processes_match_one_process(workers, single):
    nproc, got_ranks = workers
    for rank, got in enumerate(got_ranks):
        assert sorted(got) == sorted(single)
        for key, want in single.items():
            rtol = RTOL_PCG if "pcg" in key else RTOL
            np.testing.assert_allclose(got[key], want, rtol=rtol, atol=0,
                                       err_msg=f"rank {rank} {key}")


def test_rdma_field_is_sweeps(workers):
    """halo="rdma" across processes gives halo="sweep"'s field on every
    rank, bitwise: both exchange the strips by copies."""
    nproc, got_ranks = workers
    for rank, got in enumerate(got_ranks):
        np.testing.assert_array_equal(got["dist_rdma_u"],
                                      got["dist_sweep_u"],
                                      err_msg=f"{nproc} processes, rank "
                                      f"{rank}")


def test_one_process_mesh():
    """Without a process group the mesh is one process holding every
    slab, and the collectives are the slab-axis ops."""
    import torch

    from amg_tpu_torch.parallel import launch

    mesh = launch.device_mesh_1d(D)
    assert (mesh.process_count, mesh.slabs_per_process) == (1, D)
    assert list(mesh.local_slabs) == list(range(D))
    assert launch.device_mesh_1d().n_slabs == 1
    with pytest.raises(ValueError, match="do not split"):
        launch.SlabMesh(3, process_count=2)
    x = torch.arange(12.0).reshape(6, 2)
    assert torch.equal(launch.frame(x, 2)[2:8], x)
    assert launch.frame(x, 2)[[0, 1, 8, 9]].abs().sum() == 0
    assert torch.equal(launch.all_gather_slabs(x), x)
    t = torch.tensor(3.0)
    assert launch.psum(t) is t and launch.first_slab(4) == 0


if __name__ == "__main__":
    worker(*(int(a) for a in sys.argv[1:4]), sys.argv[4])
