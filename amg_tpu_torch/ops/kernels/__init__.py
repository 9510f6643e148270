"""Hand-written CUDA kernels of the port, each beside its plain version.

Every wrapper takes CPU tensors to its plain PyTorch version and CUDA
tensors to its kernel (built from ``amg_tpu_torch/csrc`` at first launch),
and counts each kernel's launches in a ``launches`` attribute.
"""

from amg_tpu_torch.ops.kernels.halo import rdma_halo_exchange
from amg_tpu_torch.ops.kernels.packed_cycle import (fused_down_leg_packed,
                                                    fused_up_leg_packed)
from amg_tpu_torch.ops.kernels.packed_df import fused_df_residual_rss
from amg_tpu_torch.ops.kernels.packed_rbgs import fused_gs4_sweep_packed
from amg_tpu_torch.ops.kernels.rbgs import (fused_gs4_sweep,
                                            fused_gs4_sweep_const,
                                            fused_gs4_sweep_var)

# the launch counters, one per kernel (K1..K7)
KERNELS = (fused_gs4_sweep_packed, fused_down_leg_packed,
           fused_up_leg_packed, fused_df_residual_rss,
           fused_gs4_sweep_const, fused_gs4_sweep_var, rdma_halo_exchange)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}
