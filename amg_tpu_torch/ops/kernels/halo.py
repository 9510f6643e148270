"""K7: the ghost-strip exchange between row slabs (``csrc/halo.cu``).

Port of the TPU kernel ``amg_tpu/ops/pallas/halo.py`` ``rdma_halo_exchange``
(``pallas_call`` at :113), the exchange of the distributed solve's
``halo="rdma"`` (parallel/structured_dist.py). The TPU kernel runs per chip
inside ``shard_map`` and pushes strips to its neighbours by remote DMA; here
the D slabs of the mesh are the leading axis of one tensor, and one launch
puts every slab's boundary strips into its neighbours' receive strips,
addressing each slab through a pointer table (csrc/halo.cu).

The slabs come as one (D, B, w) tensor (the stacked u|b slab) or as a tuple
of them (u and b, no stacking copy); the result is the (D, 2G, P*w)
receive strips: rows [0, G) the previous slab's last G rows, rows [G, 2G)
the next slab's first G rows, zeros at the line's ends. The plain version
is the single-hop ghost-strip exchange in torch, which the CPU path and
``halo="sweep"`` run.
"""

from __future__ import annotations

import ctypes

import torch

from amg_tpu_torch.ops.kernels._build import check, library, stream_of

# csrc/halo.cu's table sizes
MAX_SLABS = 128
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


def rdma_halo_exchange(slabs, G: int) -> torch.Tensor:
    """The (D, 2G, P*w) receive strips of (D, B, w) slabs (one tensor, or a
    tuple of up to two of one shape, dtype and device), 1 <= G <= B. CPU
    tensors take the plain version; CUDA tensors launch K7 (f32 or f64,
    contiguous) into a new tensor, on the current stream."""
    parts = _parts(slabs)
    x0 = parts[0]
    if x0.dim() != 3:
        raise ValueError(f"slabs must be (D, B, w), got {tuple(x0.shape)}")
    D, B, w = x0.shape
    for t in parts:
        if (t.shape != x0.shape or t.dtype != x0.dtype
                or t.device != x0.device):
            raise ValueError("slab parts must share shape, dtype and device")
    if not 1 <= G <= B:
        raise ValueError(f"single-hop exchange needs 1 <= G <= B, got "
                         f"G={G}, B={B}")
    if not 1 <= len(parts) <= MAX_PARTS or D > MAX_SLABS:
        raise ValueError(f"at most {MAX_PARTS} parts and {MAX_SLABS} slabs")
    if x0.device.type == "cpu":
        return rdma_halo_exchange_plain(parts, G)
    if x0.device.type != "cuda":
        raise ValueError(f"unsupported device {x0.device}")
    if x0.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"K7 takes float32 or float64, got {x0.dtype}")
    if not all(t.is_contiguous() for t in parts):
        raise ValueError("K7 needs contiguous slabs")
    P = len(parts)
    out = torch.empty((D, 2 * G, P * w), dtype=x0.dtype, device=x0.device)
    es = x0.element_size()
    src = (ctypes.c_void_p * (D * P))(*(
        t.data_ptr() + d * B * w * es for d in range(D) for t in parts))
    dst = (ctypes.c_void_p * D)(*(
        out.data_ptr() + d * 2 * G * P * w * es for d in range(D)))
    check(library().amg_halo_exchange(src, P, w, dst, D, B, G, w, es,
                                      stream_of(out)), "amg_halo_exchange")
    rdma_halo_exchange.launches += 1
    return out


rdma_halo_exchange.launches = 0
