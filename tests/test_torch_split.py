"""The split V-cycle level (sweep K1, residual + restriction K8, up leg K3)
and K8's plain version against amg_tpu on the same inputs (CPU).

On the CPU the kernel wrappers take their plain versions, so these tests
check K8's plain version against the Pallas kernel it replaces (interpret
mode, side 255, tg = 32 and 128, the JAX tests' bound 1e-5 relative), the
split V-cycle against JAX's split V-cycle (forced as
tests/test_packed_cycle.py forces it, same bound), and the level plan
against JAX's eligibility rules at the production sides. The CUDA kernel
is compared with the plain version on the card (chip_smoke.py,
tests/test_torch_cuda.py).
"""

from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from amg_tpu import structured as jst
from amg_tpu.models import poisson as jpoisson
from amg_tpu.ops.pallas import packed_cycle as jcycle
from amg_tpu.ops.pallas import packed_rbgs as jrbgs
from amg_tpu.ops.rap import poisson_const_w33
from amg_tpu.sparse import packed as jp

from amg_tpu_torch import structured as tst
from amg_tpu_torch.models import poisson as tpoisson
from amg_tpu_torch.ops import kernels as K
from amg_tpu_torch.ops.kernels import _build
from amg_tpu_torch.sparse import packed as tp

torch.set_num_threads(1)
CPU = torch.device("cpu")

SIDE = 255
M_ = (SIDE - 1) // 2
W33 = poisson_const_w33(SIDE, 1)[0]


def _both(seed):
    """A packed f32 field for both sides, from one numpy draw."""
    x = np.random.default_rng(seed).standard_normal((SIDE, SIDE)).astype(
        np.float32)
    return tp.pack(torch.as_tensor(x), M_), jp.pack(jnp.asarray(x), M_)


@pytest.mark.parametrize("tg", [32, 128], ids=["multi-tile", "one-tile"])
def test_residual_restrict_matches_pallas(tg):
    tu, ju = _both(0)
    tb, jb = _both(1)
    K.reset_launch_counts()
    want = np.asarray(jcycle.fused_residual_restrict_packed(
        ju, jb, W33, M_, tg=tg, interpret=True), dtype=np.float64)
    got = K.fused_residual_restrict_packed(tu, tb, W33, M_)
    assert got.shape == (M_ + 1, M_ + 1)
    g = got.numpy().astype(np.float64)
    assert (np.abs(g[:M_, :M_] - want[:M_, :M_]).max()
            / np.abs(want[:M_, :M_]).max()) < 1e-5
    assert float(got[M_, :].abs().max()) == float(got[:, M_].abs().max()) \
        == 0.0
    assert K.fused_residual_restrict_packed.launches == 0
    assert _build.library.cache_info().currsize == 0, "CPU path built CUDA"


@pytest.mark.parametrize("bad", ["dtype", "shape", "noncontiguous"])
def test_residual_restrict_refuses_bad_inputs(bad):
    u4, _ = _both(2)
    b4, _ = _both(3)
    if bad == "dtype":
        u4 = u4.double()
    elif bad == "shape":
        u4 = u4[:, :-1, :-1].contiguous()
    else:
        u4 = u4.transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        K.fused_residual_restrict_packed(u4, b4, W33, M_)


def _split_plan(monkeypatch, hier, min_side):
    monkeypatch.setattr(tst, "FUSED_PACKED_MIN_SIDE", 200)
    plan = tst.level_plan(hier, 1, 1, min_side, True)
    return ("split",) + plan[1:]


def test_split_vcycle_matches_jax(monkeypatch):
    """The port's split V-cycle at 255 (plan[0] forced to "split") against
    JAX's vcycle_packed(fused=True) with its full down leg made
    ineligible, so that it takes its split path: fused sweep, fused
    residual + restriction and up leg, all in interpret mode."""
    jh = jst.build_stencil_hierarchy_device(SIDE, dtype=jnp.float32,
                                            smoother="packed")
    b_np = np.asarray(jpoisson.rhs(SIDE, dtype=jnp.float64),
                      dtype=np.float32).reshape(SIDE, SIDE)
    b2 = jnp.asarray(b_np)
    orig_sweep = jrbgs.fused_gs4_sweep_packed
    orig_rr = jcycle.fused_residual_restrict_packed
    orig_up = jcycle.fused_up_leg_packed
    with mock.patch.object(jst, "FUSED_PACKED_MIN_SIDE", 200), \
            mock.patch.object(jst, "_mosaic_ok", lambda: True), \
            mock.patch.object(jcycle, "eligible", lambda m_: False), \
            mock.patch(
                "amg_tpu.ops.pallas.packed_rbgs.fused_gs4_sweep_packed",
                new=lambda *a, **k: orig_sweep(
                    *a, **{**k, "interpret": True})), \
            mock.patch(
                "amg_tpu.ops.pallas.packed_cycle."
                "fused_residual_restrict_packed",
                new=lambda *a, **k: orig_rr(*a, **{**k, "interpret": True})), \
            mock.patch(
                "amg_tpu.ops.pallas.packed_cycle.fused_up_leg_packed",
                new=lambda *a, **k: orig_up(*a, **{**k, "interpret": True})):
        assert jcycle.eligible_split(M_)
        want = np.asarray(jst.vcycle_packed(jh, jnp.zeros_like(b2), b2,
                                            min_side=100, fused=True))

    th = tst.build_stencil_hierarchy_device(SIDE, device=CPU)
    plan = _split_plan(monkeypatch, th, 100)
    assert plan[:2] == ("split", "packed")
    tb = torch.as_tensor(b_np)
    K.reset_launch_counts()
    got = tst.vcycle_packed(th, torch.zeros_like(tb), tb, min_side=100,
                            fused=True, plan=plan).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5
    assert all(n == 0 for n in K.launch_counts().values())


def test_split_vcycle_equals_packed_bitwise(monkeypatch):
    """On the CPU the split level's wrappers run the plain packed sweep,
    residual and restriction in the packed V-cycle's order: the split, the
    legs and the plain packed V-cycles give the same bits."""
    th = tst.build_stencil_hierarchy_device(SIDE, device=CPU)
    b2 = tpoisson.rhs(SIDE, dtype=torch.float32, device=CPU).reshape(
        SIDE, SIDE)
    split = _split_plan(monkeypatch, th, tst.PACKED_MIN_SIDE)
    legs = ("legs",) + split[1:]
    plain = tst.level_plan(th, 1, 1, tst.PACKED_MIN_SIDE, False)
    assert plain[0] == "packed"
    us = [tst.vcycle_packed(th, torch.zeros_like(b2), b2, plan=p)
          for p in (split, legs, plain)]
    assert torch.equal(us[0], us[2]) and torch.equal(us[1], us[2])


def _jax_kind(side: int, sweeps: int) -> str:
    """What JAX's vcycle_packed(fused=True) runs on a constant packed level
    of a real TPU (amg_tpu/structured.py:443-462), from its pure integer
    eligibility rules."""
    m = (side - 1) // 2
    if side < jst.PACKED_MIN_SIDE:
        return "masked"
    if side < jst.FUSED_PACKED_MIN_SIDE or not jrbgs.eligible(m):
        return "packed"
    if sweeps == 1 and jcycle.eligible(m):
        return "legs"
    if sweeps == 1 and jcycle.eligible_split(m):
        return "split"
    return "sweep"


@pytest.mark.parametrize("sweeps", [1, 2])
@pytest.mark.parametrize("side", [1023, 2047, 4095, 8191])
def test_level_plan_matches_jax_eligibility(side, sweeps):
    """The plan of the Poisson hierarchy (its shapes alone, on the meta
    device) against JAX's rules; JAX's masked levels, all 127^2 and
    below, are the port's masked legs K10/K11, and its plain packed
    levels, 511^2 and 255^2 below the TPU's VMEM gate, take the fused
    kernels on the card: the legs with one sweep, K1 with two."""
    hier = tst.build_stencil_hierarchy_device(side, device="meta")
    plan = tst.level_plan(hier, sweeps, sweeps, tst.PACKED_MIN_SIDE, True)
    want = tuple(_jax_kind(s, sweeps) for s in hier.sides[:-1]) + ("direct",)
    port = {"masked": "masked_legs",
            "packed": "legs" if sweeps == 1 else "sweep"}
    assert want.count("packed") == 2
    assert plan == tuple(port.get(k, k) for k in want)
    assert (plan[0] == "split") == (side >= tst.SPLIT_MIN_SIDE
                                    and sweeps == 1)


def test_split_solve_call_counts_follow_the_plan(monkeypatch):
    """With both fused thresholds at the fine side, the solve's fine level
    is split: the sweep, the residual + restriction and the up leg run
    1 + 3 it times (FMG fine pass + 3 cycles per refine), the down leg
    never; the refine count is the plain packed solve's."""
    side = SIDE
    monkeypatch.setattr(tst, "FUSED_PACKED_MIN_SIDE", side)
    monkeypatch.setattr(tst, "SPLIT_MIN_SIDE", side)
    names = ("fused_gs4_sweep_packed", "fused_residual_restrict_packed",
             "fused_down_leg_packed", "fused_up_leg_packed",
             "fused_df_residual_rss")
    calls = {n: [] for n in names}
    for n in names:
        orig = getattr(tst, n)

        def counted(*a, _orig=orig, _n=n, **k):
            calls[_n].append(1)
            return _orig(*a, **k)
        monkeypatch.setattr(tst, n, counted)
    s = tst.StructuredSolver(side, device=CPU)
    assert s.plan[0] == "split"
    b2 = tpoisson.rhs(side, device=CPU).reshape(side, side)
    res = s.solve_ir_fused(b2, tolerance=1e-7)
    it = res.iterations // s.cycles_per_refine
    n = {k: len(v) for k, v in calls.items()}
    assert res.converged and it >= 1
    assert n["fused_gs4_sweep_packed"] == n["fused_residual_restrict_packed"] \
        == n["fused_up_leg_packed"] == 1 + 3 * it
    assert n["fused_down_leg_packed"] == 0
    assert n["fused_df_residual_rss"] == it + 1
    ref = tst.StructuredSolver(side, smoother="packed", device=CPU
                               ).solve_ir_fused(b2, tolerance=1e-7)
    assert ref.iterations == res.iterations
