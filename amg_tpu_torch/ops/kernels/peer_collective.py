"""The collectives of the distributed solvers' blocks as one kernel
(``csrc/peer_collective.cu``), so that they can live inside their loop
graphs.

The port's own kernel: it replaces no TPU kernel. JAX's ``shard_map``
programs run ``psum``, ``all_gather`` and the one-row ``ppermute`` halos
as XLA collectives inside their ``while_loop``s
(``amg_tpu/parallel/structured_dist.py``), across the hosts too. The
port's blocks are the threads of a card group (one process driving K
blocks), the processes of a process group, or both (``parallel/launch.py``),
and the host collectives between them (events, copies between the cards,
a host barrier, torch.distributed) cannot be captured into a conditional
node's body, which holds kernels of one device only. One launch of this
kernel puts a block's payload into every other block's memory (the same
card, another by peer access, another process's through CUDA IPC), raises
an epoch flag there, waits for theirs, and then either gathers the K
payloads in block order or adds them in block order:

* ``GATHER``: ``(K, *x.shape)``, block q's ``x`` at q (``all_gather_slabs``,
  and the edge rows of ``launch.edges``);
* ``SUM``: ``x``'s shape, the K payloads added in block order,
  ``((x_0 + x_1) + x_2) + ...`` (``launch.psum``), f32 or f64.

The memory is ``launch.GroupCollectives``: one allocation a block that the
other blocks address, made by every block together. The plain version is
the host collectives (``launch._gather_host`` and ``launch._psum_host``:
copies in a card group, ``all_gather`` across processes, the partials
added in block order), which a CPU tensor takes; on the card there is no
fallback to them: a launch error raises here, and a wait that timed out
(``TIMEOUT_S``) sets the status that ``GroupCollectives.check`` raises on
after the solve.
"""

from __future__ import annotations

from array import array

import torch

from amg_tpu_torch.ops.kernels._build import (check, count_launch, library,
                                              stream_of)

GATHER, SUM = 0, 1
MAX_BLOCKS = 8        # csrc/peer_collective.cu kMaxBlocks
CHUNK = 16384         # kChunk: the bytes behind one flag
MAX_GRID = 16         # kMaxGrid
TIMEOUT_S = 60.0      # how long a launch waits for another block's payload

# CollectiveCall's fields (csrc/peer_collective.cu), in order
(_SRC, _OUT, _NBYTES, _BLOCK, _BLOCKS, _MODE, _CAP, _TIMEOUT, _STATUS, _STREAM,
 _GRID, _BASES) = range(12)


def call_template(K: int, k: int, cap: int, bases, status: torch.Tensor,
                  timeout_s: float) -> array:
    """The packed call of block ``k`` of ``K`` over the allocations
    ``bases`` (block order) with slots of ``cap`` bytes; a launch fills in
    the payload, the output, the mode and the stream."""
    c = array("q", [0] * (_BASES + MAX_BLOCKS))
    c[_BLOCK], c[_BLOCKS], c[_CAP] = k, K, cap
    c[_TIMEOUT] = int(timeout_s * 1e9)
    c[_STATUS] = status.data_ptr()
    for q, b in enumerate(bases):
        c[_BASES + q] = b
    return c


def peer_collective(x: torch.Tensor, mem, mode: int) -> torch.Tensor:
    """One collective of this block's ``x`` (the same shape and dtype on
    every block) over the K blocks of the mesh: ``GATHER`` gives the
    (K, *x.shape) payloads in block order, ``SUM`` their sum in block
    order. CPU tensors take the plain version, the host collectives;
    CUDA tensors launch the kernel on the current stream with ``mem``,
    the block's ``launch.GroupCollectives``."""
    if mode not in (GATHER, SUM):
        raise ValueError(f"unknown collective mode {mode}")
    if x.is_cpu:
        # the plain version is a collective, in the layer above this one
        from amg_tpu_torch.parallel import launch
        return (launch._gather_host(x) if mode == GATHER
                else launch._psum_host(x))
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    if mode == SUM and x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the sum takes float32 or float64, got {x.dtype}")
    x = x.contiguous()
    nbytes = x.numel() * x.element_size()
    if nbytes % 4 or nbytes == 0:
        raise ValueError(f"a payload of {nbytes} bytes: a nonzero multiple "
                         f"of 4 is moved")
    mem.ensure(nbytes)
    out = (torch.empty((mem.K, *x.shape), dtype=x.dtype, device=x.device)
           if mode == GATHER else torch.empty_like(x))
    c = mem.call
    c[_SRC], c[_OUT], c[_NBYTES] = x.data_ptr(), out.data_ptr(), nbytes
    c[_MODE] = 0 if mode == GATHER else (1 if x.dtype == torch.float32
                                         else 2)
    c[_STREAM] = stream_of(x)
    c[_GRID] = min(MAX_GRID, -(-nbytes // CHUNK))
    check(library().amg_peer_collective(c.buffer_info()[0]),
          "amg_peer_collective")
    count_launch(peer_collective)
    return out


peer_collective.launches = 0
