"""K5/K6's plain version (amg_tpu_torch/ops/kernels/rbgs.py) against the
TPU kernel it replaces, amg_tpu's fused_gs4_sweep, run as the JAX
package's own tests run it (tests/test_pallas_rbgs.py: interpret mode,
PaddedStencil.prepare(S, tr=16), f64), and the wrapper's CPU behaviour.

Tolerances: 1e-12 against the Pallas kernel in f64 (the JAX test's own
bound for the kernel against the reference sweep); 1e-5 relative against
gs4_sweep_masked in f32, which puts the diagonal inside the sum and so
rounds differently (a few f32 ulps per color step on O(1/h^2) terms).
The CUDA kernels are held against the plain version on the card
(chip_smoke.py, tests/test_torch_cuda.py).
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from amg_tpu.models import poisson as jpoisson
from amg_tpu.models import varcoef as jvar
from amg_tpu.ops.pallas.rbgs import PaddedStencil, fused_gs4_sweep
from amg_tpu.ops.transfer import linear_interp_1d
from amg_tpu.sparse.stencil import Stencil2D as JStencil2D

from amg_tpu_torch import structured as tst
from amg_tpu_torch.ops import kernels as K
from amg_tpu_torch.ops.kernels import _build
from amg_tpu_torch.ops.kernels.rbgs import fused_gs4_sweep_plain
from amg_tpu_torch.sparse.stencil import Stencil2D, color_masks_iota
from amg_tpu_torch.sparse.stencil import gs4_sweep_masked

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _no_launch_no_build():
    K.reset_launch_counts()
    yield
    assert all(n == 0 for n in K.launch_counts().values())
    assert _build.library.cache_info().currsize == 0, "CPU path built CUDA"


def _port_op(JS, const):
    """The port's operator for a JAX Stencil2D: its w33 (K5) or its
    planes (K6)."""
    if const:
        return Stencil2D.const(JS.w33, JS.side)
    return Stencil2D(side=JS.side, c=torch.tensor(np.asarray(JS.c)))


def _check_against_pallas(JS, const, omega=1.0, symmetric=True):
    side = JS.side
    if not const:
        JS = dataclasses.replace(JS, w33=None)   # force the var kernel
    rng = np.random.default_rng(side)
    u0 = rng.standard_normal((side, side))
    b2 = rng.standard_normal((side, side))
    ps = PaddedStencil.prepare(JS, tr=16, dtype=jnp.float64)
    out = fused_gs4_sweep(ps, ps.pad_field(jnp.asarray(u0)),
                          ps.pad_field(jnp.asarray(b2)), omega=omega,
                          symmetric=symmetric, interpret=True)
    want = np.asarray(ps.unpad_field(out))
    got = fused_gs4_sweep_plain(_port_op(JS, const), torch.tensor(u0),
                                torch.tensor(b2), omega, symmetric).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def _galerkin(side_f=63, side_c=31):
    A = jpoisson.laplacian_scipy(side_f)
    P1 = linear_interp_1d(side_f, side_c)
    P = sp.kron(P1, P1).tocsr()
    return JStencil2D.from_scipy((P.T @ (A @ P)).tocsr(), side_c,
                                 dtype=jnp.float64)


def _poisson(side=33):
    return JStencil2D.from_scipy(jpoisson.laplacian_scipy(side), side,
                                 dtype=jnp.float64)


KINDS = pytest.mark.parametrize("const", [True, False],
                                ids=["K5-const", "K6-var"])


@KINDS
def test_plain_matches_pallas_5pt(const):
    JS = _poisson()
    assert JS.w33 is not None
    _check_against_pallas(JS, const)


@KINDS
def test_plain_matches_pallas_9pt_galerkin(const):
    _check_against_pallas(_galerkin(), const)


@KINDS
def test_plain_matches_pallas_omega_forward_only(const):
    _check_against_pallas(_poisson(31), const, omega=1.4, symmetric=False)


def test_plain_matches_pallas_jump_planes():
    side = 31
    c = np.asarray(jvar.jump_planes(side, a_in=100.0, dtype=jnp.float64))
    JS = JStencil2D(c=jnp.asarray(c), side=side, w33=None)
    _check_against_pallas(JS, const=False, omega=0.9)


@pytest.mark.parametrize("symmetric", [True, False])
@KINDS
def test_plain_close_to_masked_sweep_f32(const, symmetric):
    """The same sweep as gs4_sweep_masked, rounded differently."""
    JS = _galerkin()
    S = _port_op(JS, const)
    if not const:
        S = Stencil2D(side=S.side, c=S.c.float())
    rng = np.random.default_rng(5)
    u = torch.tensor(rng.standard_normal((S.side, S.side)),
                     dtype=torch.float32)
    b = torch.tensor(rng.standard_normal((S.side, S.side)),
                     dtype=torch.float32)
    got = fused_gs4_sweep_plain(S, u, b, 0.9, symmetric)
    want = gs4_sweep_masked(S, u, b, color_masks_iota(S.side), 0.9,
                            symmetric)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5


@KINDS
def test_wrapper_takes_plain_version_on_cpu(const):
    S = _port_op(_galerkin(), const)
    if not const:
        S = Stencil2D(side=S.side, c=S.c.float())
    u = torch.randn(S.side, S.side, generator=torch.Generator().manual_seed(1))
    b = torch.randn(S.side, S.side, generator=torch.Generator().manual_seed(2))
    got = K.fused_gs4_sweep(S, u, b, 1.2, True)
    assert torch.equal(got, fused_gs4_sweep_plain(S, u, b, 1.2, True))
    assert not torch.equal(got, u)


@pytest.mark.parametrize("bad", ["dtype", "shape", "noncontiguous",
                                 "planes_dtype"])
def test_wrapper_refuses_bad_inputs(bad):
    side = 31
    S = Stencil2D(side=side, c=torch.zeros(3, 3, side, side))
    u = torch.zeros(side, side)
    b = torch.zeros(side, side)
    if bad == "dtype":
        u = u.double()
    elif bad == "shape":
        u = u[:-1, :-1].contiguous()
    elif bad == "noncontiguous":
        u = torch.zeros(side, 2 * side)[:, ::2]
        assert not u.is_contiguous()
    else:
        S = Stencil2D(side=side, c=S.c.double())
    with pytest.raises((TypeError, ValueError)):
        K.fused_gs4_sweep(S, u, b)


@pytest.mark.parametrize("var", [False, True], ids=["const", "var"])
def test_fused_smoother_dispatch(monkeypatch, var):
    """With FUSED_MIN_SIDE lowered to the fine side, a smoother="fused"
    V-cycle calls fused_gs4_sweep twice on the fine level (pre and post)
    and matches the masked V-cycle closely (same sweep, other rounding)."""
    side = 63
    planes = (torch.tensor(np.asarray(jvar.jump_planes(side)))
              if var else None)

    def hier(smoother):
        if var:
            return tst.build_stencil_hierarchy_planes(planes, device=CPU,
                                                      smoother=smoother)
        return tst.build_stencil_hierarchy_device(side, device=CPU,
                                                  smoother=smoother)

    b = torch.tensor(np.random.default_rng(3).standard_normal((side, side)),
                     dtype=torch.float32)
    want = tst.vcycle_stencil(hier("masked"), torch.zeros_like(b), b)
    calls = []
    orig = tst.fused_gs4_sweep
    monkeypatch.setattr(tst, "fused_gs4_sweep",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    monkeypatch.setattr(tst, "FUSED_MIN_SIDE", side)
    h = hier("fused")
    got = tst.vcycle_stencil(h, torch.zeros_like(b), b)
    assert len(calls) == 2
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5
    assert h.kinds[0] == ("fused_var" if var else "fused_const")
    assert set(h.kinds[1:-1]) == {"masked_k12" if var else "masked_legs"}
    assert h.kinds[-1] == "direct"
