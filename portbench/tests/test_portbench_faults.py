"""The comparison that decides ``correct``, driven through the rest of a
run (the harness without its look for a card, on the CPU at a small
side) with the timed path broken underneath: each fault that a cell can
have makes ``correct`` false, and the sound run stays true."""

import time

import pytest
import torch

from portbench import harness

SIDE = 63
SEED = 2**31 + 99
CPU = torch.device("cpu")
ONE_CARD = tuple(w["name"] for w in harness.manifest()["workloads"]
                 if w["chips"] == 1)


class Broken:
    """The driver with its answers changed where they are produced."""

    def __init__(self, drv, fault):
        self.drv, self.fault = drv, fault
        self.cycles_per_refine = drv.cycles_per_refine

    def warmup(self):
        self.drv.warmup()

    def submit(self, b):
        return self.drv.submit(b)

    def read(self, p):
        u, rss, refines = self.drv.read(p)
        return self.fault(u), rss, refines

    def close(self):
        self.drv.close()


def unchanged(u):
    """The solve hands back the state it started from (u = 0)."""
    return torch.zeros_like(u)


def half_left_out(u):
    """Half of the rows left out, the rest as solved."""
    v = u.clone()
    v[u.shape[0] // 2:] = 0.0
    return v


def altered(u):
    """One value of the answer altered where it is produced."""
    v = u.clone()
    v[u.shape[0] // 3, u.shape[1] // 3] += 1e-3
    return v


FAULTS = [unchanged, half_left_out, altered]


def run(cell, faults=None, bench=None):
    return harness.run_cell(cell, SEED, 0.2, False, CPU, time.time(),
                            overrides={"side": SIDE}, faults=faults,
                            bench=bench)


def sound(out):
    assert out["correct"], out["checks"]
    assert out["checks"]["rss_max"]["value"] <= \
        out["checks"]["rss_max"]["limit"]


@pytest.mark.parametrize("cell", ONE_CARD)
def test_sound_run_is_correct(cell):
    sound(run(cell))


def test_sound_four_slab_run_is_correct(dist_bench):
    sound(run(dist_bench[0], bench=dist_bench[1]))


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", ONE_CARD)
def test_fault_is_caught(cell, fault):
    out = run(cell, faults=lambda d: Broken(d, fault))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_fault_is_caught_on_four_slabs(dist_bench, fault):
    out = run(dist_bench[0], faults=lambda d: Broken(d, fault),
              bench=dist_bench[1])
    assert not out["correct"], out["checks"]


def test_exchange_left_out_is_caught(monkeypatch, dist_bench):
    """The slabs' exchange left out (every ghost row zero): each slab
    solves its own Dirichlet problem, and says it converged."""
    from amg_tpu_torch.parallel import structured_dist as sd

    def no_halo(u):
        z = torch.zeros_like(u[:, :1])
        return z, z

    def no_strips(uv, G, out=None):
        u = uv[0]
        D, _, n = u.shape
        return torch.zeros((D, 2 * G, 2 * n), dtype=u.dtype)

    def no_windows(x, G):
        D, B, n = x.shape[-3:]
        full = torch.zeros((*x.shape[:-3], D, B + 2 * G, n), dtype=x.dtype)
        full[..., G:G + B, :] = x
        return full

    monkeypatch.setattr(sd, "_halo", no_halo)
    monkeypatch.setattr(sd, "rdma_halo_exchange", no_strips)
    monkeypatch.setattr(sd, "_windows", no_windows)
    out = run(dist_bench[0], bench=dist_bench[1])
    assert not out["correct"], out["checks"]
