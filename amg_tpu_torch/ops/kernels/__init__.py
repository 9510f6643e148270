"""Hand-written CUDA kernels of the port, each beside its plain version.

Every wrapper takes CPU tensors to its plain PyTorch version and CUDA
tensors to its kernel (built from ``amg_tpu_torch/csrc`` at first launch),
and counts each kernel's launches in a ``launches`` attribute. The
launches inside the loop graphs (``graph_loop``) reach the counts when
they are read or reset.
"""

from amg_tpu_torch.ops.kernels import graph_loop, peer_collective
from amg_tpu_torch.ops.kernels.halo import rdma_halo_exchange
from amg_tpu_torch.ops.kernels.masked_cycle import (masked_down_leg,
                                                    masked_up_leg)
from amg_tpu_torch.ops.kernels.packed_cycle import (
    fused_down_leg_packed, fused_residual_restrict_packed,
    fused_up_leg_packed)
from amg_tpu_torch.ops.kernels.packed_df import fused_df_residual_rss
from amg_tpu_torch.ops.kernels.packed_rbgs import fused_gs4_sweep_packed
from amg_tpu_torch.ops.kernels.packed_rm import fused_gs4_sweep_rm
from amg_tpu_torch.ops.kernels.rbgs import (fused_gs4_sweep,
                                            fused_gs4_sweep_const,
                                            fused_gs4_sweep_var,
                                            masked_gs4_sweep_var)

# the launch counters, one per kernel (K1..K9, then the loop graphs'
# condition kernel and a card group's collectives inside them, then the
# masked V-cycle's legs K10 and K11, then the masked sweep on planes K12)
KERNELS = (fused_gs4_sweep_packed, fused_down_leg_packed,
           fused_up_leg_packed, fused_df_residual_rss,
           fused_gs4_sweep_const, fused_gs4_sweep_var, rdma_halo_exchange,
           fused_residual_restrict_packed, fused_gs4_sweep_rm,
           graph_loop.loop_condition, peer_collective.peer_collective,
           masked_down_leg, masked_up_leg, masked_gs4_sweep_var)


def reset_launch_counts() -> None:
    graph_loop.settle()
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    graph_loop.settle()
    return {k.__name__: k.launches for k in KERNELS}
