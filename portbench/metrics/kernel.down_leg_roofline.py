"""K2 (``fused_down_leg_packed``: pre-smooth, residual and restriction in
one pass) alone at the finest leg level of the cell's grid (M = 2048 at
4095^2), on packed fields the benchmark makes from the seed: its least
time (``roofline.down_leg``: each input read once, each output written
once, at the card's peaks) over its time, CUDA events over warm launches,
in percent."""

import torch

from amg_tpu_torch.ops.kernels import fused_down_leg_packed
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
        lambda: fused_down_leg_packed(u4, b4, w33, m, 1.0, True), run.device)
    least, _ = roofline.least_seconds(torch.cuda.get_device_name(run.device),
                                      *roofline.down_leg(M))
    return 100.0 * least / seconds
