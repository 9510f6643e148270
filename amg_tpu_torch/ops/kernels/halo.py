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
exchange in torch.

The call is lean on the host, since the kernel's bytes take less time than
its launch: no per-slab loop, and one C call whose one argument is the
packed scalars.

Across blocks (``rdma_halo_exchange_peer``) each of P blocks holds D/P
consecutive slabs, and one launch also puts the strips at the ends of its
block straight into the receive memory of blocks p-1 and p+1 and waits on
flags there for theirs: the TPU kernel's remote copies under semaphores.
A block is a process (the neighbours' memory mapped through CUDA IPC) or
a thread of a card group, one process driving several cards (the
neighbours' memory reached by peer access; two blocks may share a card).
``PeerStrips`` is that memory for one exchange shape, made and released
by every block together (``parallel/launch.py`` ``open_peer_strips``).
The plain version is the strip exchange across the blocks,
``launch.strips``: one batch of send/recv, or copies between the cards.
On the card there is no fallback to it: a failed mapping or peer access,
a launch error or a wait that times out (``PEER_TIMEOUT_S``) raises.
"""

from __future__ import annotations

import ctypes
from array import array

import torch

from amg_tpu_torch.ops.kernels._build import (check, count_launch, library,
                                              stream_of)

MAX_SLABS = 65535   # csrc/halo.cu: the grid's y extent
MAX_PARTS = 2
CHUNK = 256         # csrc/halo.cu THREADS: the columns behind one flag
PEER_TIMEOUT_S = 60.0   # how long a launch waits for a neighbour's strips
_ALIGN = 256


def _parts(slabs) -> tuple:
    return (slabs,) if isinstance(slabs, torch.Tensor) else tuple(slabs)


def rdma_halo_exchange_plain(slabs, G: int, above: torch.Tensor | None = None,
                             below: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """The single-hop exchange with tensor ops: a shift by one slab along
    the slab axis of each slab's last and first G rows; beyond the ends
    the (G, P*w) rows ``above`` the first slab and ``below`` the last
    (None: zeros, the line's ends). Any dtype, any device."""
    x = torch.cat(_parts(slabs), dim=2)
    B = x.shape[1]
    z = torch.zeros_like(x[0, :G])
    top = torch.cat([(z if above is None else above)[None], x[:-1, B - G:]])
    bot = torch.cat([x[1:, :G], (z if below is None else below)[None]])
    return torch.cat([top, bot], dim=1)


def _checked(slabs, G: int) -> tuple:
    """(parts, D, B, w, strides) of slabs the kernels take; raises on the
    rest."""
    parts = _parts(slabs)
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
        # one slab: its stride is never used
        if x1.stride()[D == 1:] != st[D == 1:]:
            raise ValueError(f"slab parts must share strides, got {st} and "
                             f"{x1.stride()}")
    if st[2] != 1 and w > 1:
        raise ValueError(f"slab rows must be contiguous, got strides {st}")
    if not 1 <= G <= B:
        raise ValueError(f"single-hop exchange needs 1 <= G <= B, got "
                         f"G={G}, B={B}")
    if not (x0.is_cpu or x0.is_cuda):
        raise ValueError(f"unsupported device {x0.device}")
    if x0.is_cuda and x0.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"K7 takes float32 or float64, got {x0.dtype}")
    return parts, D, B, w, st


def rdma_halo_exchange(slabs, G: int, out: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """The (D, 2G, P*w) receive strips of (D, B, w) slabs (one tensor, or a
    tuple of two of one shape, dtype, device and strides, rows contiguous),
    1 <= G <= B, into ``out`` (a contiguous (D, 2G, P*w) tensor of their
    dtype and device, overlapping no slab) or a new tensor. CPU tensors
    take the plain version; CUDA tensors launch K7 (f32 or f64) on the
    current stream."""
    parts, D, B, w, st = _checked(slabs, G)
    x0, P = parts[0], len(parts)
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
    if out is None:
        out = torch.empty((D, 2 * G, W), dtype=x0.dtype, device=x0.device)
    # csrc/halo.cu HaloCall, packed
    call = array("q", (x0.data_ptr(), parts[1].data_ptr() if P == 2 else 0,
                       st[0], st[1], out.data_ptr(), 2 * G * W, D, B, G, w,
                       P, x0.element_size(), stream_of(x0)))
    check(library().amg_halo_exchange(call.buffer_info()[0]),
          "amg_halo_exchange")
    count_launch(rdma_halo_exchange)
    return out


rdma_halo_exchange.launches = 0


# ---------------------------------------------------------------------------
# Across blocks: processes, or the threads of a card group.


def _align(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def peer_layout(D: int, G: int, W: int, elsize: int) -> dict:
    """Byte offsets in one block's allocation for an exchange of D slabs
    (this block's) with strips G x W (csrc/halo.cu, the peer form):
    ``out`` (D, 2G, W) at 0, the receive ``slots`` [2][2][G][W], the
    ``flags`` [2][chunks] and two counter words; ``nbytes`` in all."""
    chunks = -(-W // CHUNK)
    slots = _align(D * 2 * G * W * elsize)
    flags = _align(slots + 4 * G * W * elsize)
    return dict(chunks=chunks, out=0, slots=slots, flags=flags,
                nbytes=flags + 4 * (2 * chunks + 2))


# HaloPeerCall's fields (csrc/halo.cu), in order
(_SRC0, _SRC1, _SLAB, _PITCH, _DST, _DST_SLAB, _D, _B, _G, _W, _PARTS,
 _ELSIZE, _STREAM, _SLOTS, _ABOVE_SLOTS, _BELOW_SLOTS, _FLAGS, _ABOVE_FLAGS,
 _BELOW_FLAGS, _STATUS, _TIMEOUT) = range(21)


class PeerStrips:
    """K7's memory across blocks for one exchange shape: D slabs of
    this block, strips of G rows of width W (u and b side by side), in
    ``dtype``, laid out by ``peer_layout`` in ``mem`` (``launch.PeerMemory``
    of ``peer_layout(...)["nbytes"]`` bytes, which the neighbours have
    reach; ``launch.open_peer_strips`` makes both). ``out`` is the
    (D, 2G, W) receive strips a call returns; ``status`` the host words a
    timed-out wait writes, shared by the strips opened together."""

    def __init__(self, D: int, G: int, W: int, dtype, mem,
                 status: torch.Tensor, timeout_s: float):
        es = torch.empty((), dtype=dtype).element_size()
        lay = peer_layout(D, G, W, es)
        self.shape, self.dtype, self.status = (D, 2 * G, W), dtype, status
        self.mem = m = mem
        self.out = m.local[:D * 2 * G * W * es].view(dtype).view(self.shape)
        slots = lambda base: base + lay["slots"] if base else 0  # noqa: E731
        flags = lambda base: base + lay["flags"] if base else 0  # noqa: E731
        self.call = array("q", [0] * 21)
        c = self.call
        c[_DST], c[_DST_SLAB], c[_D], c[_G] = m.base, 2 * G * W, D, G
        c[_ELSIZE], c[_STATUS] = es, status.data_ptr()
        c[_SLOTS], c[_FLAGS] = slots(m.base), flags(m.base)
        c[_ABOVE_SLOTS], c[_ABOVE_FLAGS] = slots(m.above), flags(m.above)
        c[_BELOW_SLOTS], c[_BELOW_FLAGS] = slots(m.below), flags(m.below)
        c[_TIMEOUT] = int(timeout_s * 1e9)
        self._timed_out = (ctypes.c_int * 2).from_address(status.data_ptr())

    def check(self) -> None:
        """Raise if a wait of these strips (or of any opened with them)
        timed out: a neighbour did not put its strips in time."""
        if self._timed_out[0]:
            raise RuntimeError(
                f"K7 across blocks: a wait for a neighbour's strips "
                f"timed out (epoch {self._timed_out[1]}); the neighbour "
                f"block stopped or fell behind by more than the bound")


def rdma_halo_exchange_peer(slabs, G: int, strips: PeerStrips | None = None
                            ) -> torch.Tensor:
    """``rdma_halo_exchange`` of this block's (D/P, B, w) slabs across
    the process group or the card group: the (D/P, 2G, P*w) receive
    strips, the ones at the ends of its block from blocks p-1 and p+1. CPU
    tensors take the plain version (``strips`` unused). CUDA tensors
    launch K7's peer form on the current stream into ``strips.out``
    (``strips``: the shape's PeerStrips, which every block calls in the
    same order)."""
    parts, D, B, w, st = _checked(slabs, G)
    x0, P = parts[0], len(parts)
    if x0.is_cpu:
        # the plain version is a collective, in the layer above this one
        from amg_tpu_torch.parallel.launch import strips as plain
        return plain(torch.cat(parts, dim=2), G)
    if strips is None:
        raise ValueError("K7 across blocks on the card needs the "
                         "exchange's PeerStrips (launch.open_peer_strips)")
    if (strips.shape != (D, 2 * G, P * w) or strips.dtype != x0.dtype
            or strips.out.device != x0.device):
        raise ValueError(f"strips are {strips.shape} {strips.dtype} on "
                         f"{strips.out.device}, the slabs need "
                         f"{(D, 2 * G, P * w)} {x0.dtype} on {x0.device}")
    strips.check()
    c = strips.call
    c[_SRC0], c[_SRC1] = x0.data_ptr(), parts[1].data_ptr() if P == 2 else 0
    c[_SLAB], c[_PITCH], c[_B], c[_W], c[_PARTS] = st[0], st[1], B, w, P
    c[_STREAM] = stream_of(x0)
    check(library().amg_halo_exchange_peer(c.buffer_info()[0]),
          "amg_halo_exchange_peer")
    count_launch(rdma_halo_exchange)
    return strips.out
