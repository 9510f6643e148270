"""K7: the ghost-strip exchange between row slabs (``csrc/halo.cu``).

Port of the TPU kernel ``amg_tpu/ops/pallas/halo.py`` ``rdma_halo_exchange``
(``pallas_call`` at :113), the exchange of the distributed solve's
``halo="rdma"`` (parallel/structured_dist.py). The TPU kernel runs per chip
inside ``shard_map`` and pushes strips to its neighbours by remote DMA; here
the D slabs of the mesh are the leading axis of one tensor, and one launch
puts every slab's boundary strips into its neighbours' receive strips. The
kernel gets each part's base pointer with the slab stride and row pitch
the parts share, and computes every slab's address itself.

The slabs come as one (D, B, w) tensor (the stacked u|b slab) or as a tuple
of two of them (u and b, no stacking copy), each with contiguous rows and
the same strides (a view such as the slab rows of a framed field will do);
the result is the (D, 2G, P*w) receive strips: rows [0, G) the previous
slab's last G rows, rows [G, 2G) the next slab's first G rows, zeros at the
line's ends. ``out=`` takes a contiguous receive buffer the caller owns, so
a call allocates nothing. The plain version is the single-hop ghost-strip
exchange in torch, which the CPU path and ``halo="sweep"`` run.

The call is lean on the host, since the kernel's bytes take less time than
its launch: no per-slab loop, and one C call whose one argument is the
packed scalars.
"""

from __future__ import annotations

from array import array

import torch

from amg_tpu_torch.ops.kernels._build import check, library, stream_of

MAX_SLABS = 65535   # csrc/halo.cu: the grid's y extent
MAX_PARTS = 2


def _parts(slabs) -> tuple:
    return (slabs,) if isinstance(slabs, torch.Tensor) else tuple(slabs)


def rdma_halo_exchange_plain(slabs, G: int) -> torch.Tensor:
    """The single-hop exchange with tensor ops: a shift by one slab along
    the slab axis, zero-filled at the ends, of each slab's last and first G
    rows. Any dtype, any device."""
    x = torch.cat(_parts(slabs), dim=2)
    B = x.shape[1]
    z = torch.zeros_like(x[:1, :G])
    top = torch.cat([z, x[:-1, B - G:]], dim=0)
    bot = torch.cat([x[1:, :G], z], dim=0)
    return torch.cat([top, bot], dim=1)


def rdma_halo_exchange(slabs, G: int, out: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """The (D, 2G, P*w) receive strips of (D, B, w) slabs (one tensor, or a
    tuple of two of one shape, dtype, device and strides, rows contiguous),
    1 <= G <= B, into ``out`` (a contiguous (D, 2G, P*w) tensor of their
    dtype and device, overlapping no slab) or a new tensor. CPU tensors
    take the plain version; CUDA tensors launch K7 (f32 or f64) on the
    current stream."""
    parts = (slabs,) if isinstance(slabs, torch.Tensor) else tuple(slabs)
    x0 = parts[0]
    if x0.dim() != 3:
        raise ValueError(f"slabs must be (D, B, w), got {tuple(x0.shape)}")
    P = len(parts)
    if not 1 <= P <= MAX_PARTS:
        raise ValueError(f"at most {MAX_PARTS} parts")
    D, B, w = x0.shape
    if D > MAX_SLABS:
        raise ValueError(f"at most {MAX_SLABS} slabs")
    st = x0.stride()
    if P == 2:
        x1 = parts[1]
        if (x1.shape != x0.shape or x1.dtype != x0.dtype
                or x1.device != x0.device):
            raise ValueError("slab parts must share shape, dtype and device")
        if x1.stride() != st:
            raise ValueError(f"slab parts must share strides, got {st} and "
                             f"{x1.stride()}")
    if st[2] != 1 and w > 1:
        raise ValueError(f"slab rows must be contiguous, got strides {st}")
    if not 1 <= G <= B:
        raise ValueError(f"single-hop exchange needs 1 <= G <= B, got "
                         f"G={G}, B={B}")
    W = P * w
    if out is not None and (out.shape != (D, 2 * G, W)
                            or out.dtype != x0.dtype
                            or out.device != x0.device
                            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {(D, 2 * G, W)} "
                         f"{x0.dtype} tensor on {x0.device}, got "
                         f"{tuple(out.shape)} {out.dtype} on {out.device}")
    if x0.is_cpu:
        strips = rdma_halo_exchange_plain(parts, G)
        return strips if out is None else out.copy_(strips)
    if not x0.is_cuda:
        raise ValueError(f"unsupported device {x0.device}")
    if x0.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"K7 takes float32 or float64, got {x0.dtype}")
    if out is None:
        out = torch.empty((D, 2 * G, W), dtype=x0.dtype, device=x0.device)
    # csrc/halo.cu HaloCall, packed
    call = array("q", (x0.data_ptr(), parts[1].data_ptr() if P == 2 else 0,
                       st[0], st[1], out.data_ptr(), 2 * G * W, D, B, G, w,
                       P, x0.element_size(), stream_of(x0)))
    check(library().amg_halo_exchange(call.buffer_info()[0]),
          "amg_halo_exchange")
    rdma_halo_exchange.launches += 1
    return out


rdma_halo_exchange.launches = 0
