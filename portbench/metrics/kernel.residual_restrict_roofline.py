"""K8 (``fused_residual_restrict_packed``: the residual and the restriction
in one pass, on the split fine level of a grid past 4095^2) alone at the
cell's finest level (M = 4096 at 8191^2), on packed fields the benchmark
makes from the seed: its least time (``roofline.residual_restrict``:
each input read once, each output written once, at the card's peaks)
over its time, CUDA events over warm launches, in percent."""

import torch

from amg_tpu_torch.ops.kernels import fused_residual_restrict_packed
from portbench import kernels, roofline


def read(run):
    if run.device.type != "cuda":
        return None
    side = int(run.solver["side"])
    m = (side - 1) // 2
    M = m + 1
    g = kernels.generator(run)
    u4, b4 = (torch.randn((4, M, M), generator=g, dtype=torch.float32,
                          device=run.device) for _ in range(2))
    w33 = kernels.poisson5_w33(side)
    seconds = kernels.time_launches(
        lambda: fused_residual_restrict_packed(u4, b4, w33, m), run.device)
    least, _ = roofline.least_seconds(torch.cuda.get_device_name(run.device),
                                      *roofline.residual_restrict(M))
    return 100.0 * least / seconds
