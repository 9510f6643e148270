"""K7's plain version (ops/kernels/halo.py) against amg_tpu's
rdma_halo_exchange, the Pallas RDMA kernel in TPU interpret mode inside
shard_map on the 8-virtual-device mesh (as tests/test_pallas_halo.py runs
it, race detection on), and the wrapper's checks. The exchange is a copy,
so the comparisons are bitwise. The kernel itself runs only on a GPU
(tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import PartitionSpec as P

from amg_tpu.ops.pallas.halo import rdma_halo_exchange as jax_rdma

from amg_tpu_torch.ops import kernels as K
from amg_tpu_torch.ops.kernels.halo import (MAX_SLABS,
                                            rdma_halo_exchange_plain)

AXIS = "x"


def _jax_strips(x, G, D):
    """(D*B, w) -> JAX's (D, 2G, w) receive strips."""
    mesh = jax.make_mesh((D,), (AXIS,), devices=jax.devices()[:D])
    interp = pltpu.InterpretParams(detect_races=True)
    out = jax.jit(jax.shard_map(
        lambda ul: jax_rdma(ul, G, AXIS, interpret=interp), mesh=mesh,
        in_specs=P(AXIS, None), out_specs=P(AXIS, None),
        check_vma=False))(jnp.asarray(x))
    return np.asarray(out).reshape(D, 2 * G, x.shape[1])


@pytest.mark.parametrize("G", [2, 8])
def test_plain_matches_jax_kernel(G):
    """u and b given apart against JAX's kernel on the stacked u|b slab
    (as DistStructuredSolver(halo="rdma") calls it), f32."""
    D, B, n = 8, 16, 32
    rng = np.random.default_rng(G)
    u = rng.standard_normal((D, B, n)).astype(np.float32)
    b = rng.standard_normal((D, B, n)).astype(np.float32)
    want = _jax_strips(np.concatenate([u, b], axis=2).reshape(D * B, 2 * n),
                       G, D)
    got = rdma_halo_exchange_plain((torch.tensor(u), torch.tensor(b)), G)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("D,B,G", [(1, 4, 4), (2, 10, 10), (3, 6, 1),
                                   (5, 12, 5)])
def test_plain_strips(D, B, G, dtype):
    """Rows [0, G) of slab d are slab d-1's last G rows, rows [G, 2G) slab
    d+1's first G, zeros at the line's ends; G == B and one slab too. The
    wrapper on CPU tensors is the plain version and launches nothing."""
    n = 7
    x = torch.arange(D * B * n, dtype=dtype).reshape(D, B, n) + 1
    K.reset_launch_counts()
    got = K.rdma_halo_exchange(x, G)
    assert K.launch_counts()["rdma_halo_exchange"] == 0
    assert got.shape == (D, 2 * G, n) and got.dtype == dtype
    for d in range(D):
        top = x[d - 1, B - G:] if d > 0 else torch.zeros((G, n), dtype=dtype)
        bot = x[d + 1, :G] if d < D - 1 else torch.zeros((G, n), dtype=dtype)
        assert torch.equal(got[d, :G], top) and torch.equal(got[d, G:], bot)
    parts = K.rdma_halo_exchange((x, 2 * x), G)
    assert torch.equal(parts[..., :n], got)
    assert torch.equal(parts[..., n:], 2 * got)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((2, 4, 3))
    with pytest.raises(ValueError, match="1 <= G <= B"):
        K.rdma_halo_exchange(x, 5)
    with pytest.raises(ValueError, match="1 <= G <= B"):
        K.rdma_halo_exchange(x, 0)
    with pytest.raises(ValueError, match="share shape"):
        K.rdma_halo_exchange((x, torch.zeros((2, 4, 4))), 2)
    with pytest.raises(ValueError, match="share shape"):
        K.rdma_halo_exchange((x, x.double()), 2)
    with pytest.raises(ValueError, match="at most"):
        K.rdma_halo_exchange((x, x, x), 2)
    with pytest.raises(ValueError, match="at most"):
        K.rdma_halo_exchange(torch.zeros((MAX_SLABS + 1, 4, 3)), 2)
    with pytest.raises(ValueError, match="must be"):
        K.rdma_halo_exchange(torch.zeros((4, 3)), 2)


def _framed(D, B, n, G, dtype, seed):
    """(field, slabs): slabs are the (D, B, n) rows [G, G + B) of a framed
    (D, B + 2G, n + 3) field, a strided view (slab stride (B + 2G)(n + 3),
    row pitch n + 3)."""
    rng = np.random.default_rng(seed)
    f = torch.tensor(rng.standard_normal((D, B + 2 * G, n + 3)), dtype=dtype)
    return f, f[:, G:G + B, 1:n + 1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("D,B,n,G", [(4, 12, 9, 5), (3, 6, 8, 6),
                                     (1, 4, 3, 2)])
def test_strided_slabs_and_out(D, B, n, G, dtype):
    """The new argument forms on CPU tensors: u and b as strided views of
    framed fields (one slab stride and row pitch), and ``out=`` a buffer
    the caller owns, which is filled and returned; all equal the plain
    version on contiguous copies, and nothing launches."""
    _, u = _framed(D, B, n, G, dtype, 1)
    _, b = _framed(D, B, n, G, dtype, 2)
    assert not u.is_contiguous()
    ref = rdma_halo_exchange_plain((u.contiguous(), b.contiguous()), G)
    K.reset_launch_counts()
    assert torch.equal(K.rdma_halo_exchange((u, b), G), ref)
    out = torch.full((D, 2 * G, 2 * n), float("nan"), dtype=dtype)
    got = K.rdma_halo_exchange((u, b), G, out=out)
    assert got is out and torch.equal(out, ref)
    one = torch.empty((D, 2 * G, n), dtype=dtype)
    assert torch.equal(K.rdma_halo_exchange(u, G, out=one), ref[..., :n])
    assert K.launch_counts()["rdma_halo_exchange"] == 0


@pytest.mark.parametrize("case", ["transposed", "strides", "out_shape",
                                  "out_dtype", "out_strided"])
def test_wrapper_rejects_wrong_strides_and_out(case):
    """What the kernel cannot take raises on every device: rows that are
    not contiguous, parts whose strides differ, an ``out=`` of the wrong
    shape, dtype or layout."""
    D, B, n, G = 3, 8, 6, 2
    x = torch.zeros((D, B, n))
    parts, out, match = (x, x.clone()), None, "out must be"
    if case == "transposed":
        parts, match = torch.zeros((D, n, B)).transpose(1, 2), "contiguous"
    elif case == "strides":
        parts, match = (x, _framed(D, B, n, G, torch.float32, 0)[1]), \
            "share strides"
    elif case == "out_shape":
        out = torch.zeros((D, 2 * G, n))
    elif case == "out_dtype":
        out = torch.zeros((D, 2 * G, 2 * n), dtype=torch.float64)
    else:
        out = torch.zeros((D, 2 * n, 2 * G)).transpose(1, 2)
    with pytest.raises(ValueError, match=match):
        K.rdma_halo_exchange(parts, G, out=out)
