"""The port called in JAX's form where its signatures had drifted from
amg_tpu's (the port-fault list F1-F4), on the CPU: each call below raised
before the repair.

* F1: ``build_stencil_hierarchy_device`` / ``_planes`` take JAX's
  ``(side | c_fine, n_levels, dtype, smoother)`` positionally, ``device``
  after them;
* F2: ``DF32.shape``, and the accumulation ``dtype`` of ``df_rss`` /
  ``df_rss_fast`` (None: f64);
* F3: ``assert_shards_consistent(arr, mesh, expected_spec)``;
* F4: ``trace(log_dir=...)``, ``DistStructuredSolver.unpad(f2=...)``,
  ``packed_steps_window(..., row0_g=...)``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amg_tpu import structured as jst
from amg_tpu.ops import doublefloat as jdf
from amg_tpu.sparse import packed as jpacked

from amg_tpu_torch import structured as tst
from amg_tpu_torch.models import poisson, varcoef
from amg_tpu_torch.ops import doublefloat as tdf
from amg_tpu_torch.parallel import launch
from amg_tpu_torch.parallel.structured_dist import DistStructuredSolver
from amg_tpu_torch.sparse import packed as tpacked
from amg_tpu_torch.utils import debugging, profiling

torch.set_num_threads(1)


def test_f1_build_stencil_hierarchy_device_in_jax_order():
    t = tst.build_stencil_hierarchy_device(63, None, torch.float32, "packed",
                                           device="cpu")
    j = jst.build_stencil_hierarchy_device(63, None, jnp.float32, "packed")
    assert t.smoother == j.smoother == "packed"
    assert list(t.sides) == [lev.side for lev in j.levels]
    assert list(t.w33s) == [lev.w33 for lev in j.levels]


def test_f1_build_stencil_hierarchy_planes_in_jax_order():
    c = varcoef.jump_planes(31, device="cpu")
    t = tst.build_stencil_hierarchy_planes(c, 3, torch.float64, "chebyshev",
                                           device="cpu")
    j = jst.build_stencil_hierarchy_planes(jnp.asarray(c.numpy()), 3,
                                           jnp.float64, "chebyshev")
    assert t.smoother == j.smoother == "chebyshev" and t.n_levels == 3
    for l, lev in enumerate(j.levels):
        np.testing.assert_allclose(getattr(t, f"c_{l}").numpy(),
                                   np.asarray(lev.c), rtol=1e-13, atol=0)


def test_f2_df32_shape_and_rss_dtype():
    rng = np.random.default_rng(0)
    hi = rng.standard_normal((2, 17, 9)).astype(np.float32)
    lo = (rng.standard_normal((2, 17, 9)) * 1e-8).astype(np.float32)
    r = tdf.DF32(hi=torch.tensor(hi), lo=torch.tensor(lo))
    jr = jdf.DF32(hi=jnp.asarray(hi), lo=jnp.asarray(lo))
    assert r.shape == torch.Size(jr.shape) == (2, 17, 9)
    assert torch.equal(tdf.df_rss(r, torch.float64), tdf.df_rss(r))
    assert tdf.df_rss(r, torch.float64).dtype == torch.float64
    assert tdf.df_rss(r, torch.float32).dtype == torch.float32
    assert tdf.df_rss_fast(r, torch.float32).dtype == torch.float32
    assert torch.equal(tdf.df_rss_fast(r, None), tdf.df_rss_fast(r))
    # the sums' order is each library's own: df_rss's f64 sums agree to
    # rounding, f32 sums and df_rss_fast's f32 row sums to ~log2(n) eps
    for fn, jfn, dt, jdt, rtol in (
            (tdf.df_rss, jdf.df_rss, torch.float64, jnp.float64, 1e-13),
            (tdf.df_rss, jdf.df_rss, torch.float32, jnp.float32, 1e-6),
            (tdf.df_rss_fast, jdf.df_rss_fast, torch.float64, jnp.float64,
             1e-6),
            (tdf.df_rss_fast, jdf.df_rss_fast, torch.float32, jnp.float32,
             1e-6)):
        np.testing.assert_allclose(float(fn(r, dt)), float(jfn(jr, jdt)),
                                   rtol=rtol)


def test_f3_assert_shards_consistent_with_mesh_and_spec():
    mesh = launch.device_mesh_1d(4)
    rep = torch.ones(4, 3).cumsum(1)
    debugging.assert_shards_consistent(rep, mesh, ())
    debugging.assert_shards_consistent(rep, mesh, None)
    d = DistStructuredSolver(31, n_devices=4, device="cpu")
    u = d.pad_field(poisson.rhs(31, device="cpu").reshape(31, 31))
    with pytest.raises(AssertionError):
        debugging.assert_shards_consistent(u, d.mesh, ())
    with pytest.raises(ValueError, match="slabs"):
        debugging.assert_shards_consistent(rep, launch.device_mesh_1d(8), ())
    with pytest.raises(ValueError, match="replicated"):
        debugging.assert_shards_consistent(rep, mesh, ("x", None))


def test_f4_jax_keyword_names(tmp_path):
    with profiling.trace(log_dir=str(tmp_path / "t")) as prof:
        torch.mm(torch.ones(4, 4), torch.ones(4, 4))
    assert (tmp_path / "t" / "trace.json").exists()
    assert any(e.key == "aten::mm" for e in prof.key_averages())

    d = DistStructuredSolver(31, n_devices=4, device="cpu")
    f = poisson.rhs(31, device="cpu").reshape(31, 31).float()
    assert torch.equal(d.unpad(f2=d.pad_field(f)), f)

    rng = np.random.default_rng(1)
    n, R, m = 15, 12, 7
    w33 = ((-1.0, -2.0, -1.0), (-2.0, 12.0, -2.0), (-1.0, -2.0, -1.0))
    u, b = rng.standard_normal((2, R, n))
    u4 = tpacked.pack_rect(torch.tensor(u), m)
    b4 = tpacked.pack_rect(torch.tensor(b), m)
    got = tpacked.packed_steps_window(w33, u4, b4, row0_g=-2, side=n,
                                      sweeps=1, omega=1.0, symmetric=True)
    want = jpacked.packed_steps_window(
        w33, jpacked.pack_rect(jnp.asarray(u), m),
        jpacked.pack_rect(jnp.asarray(b), m), row0_g=-2, side=n, sweeps=1,
        omega=1.0, symmetric=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
