"""K6 (``fused_gs4_sweep`` on planes: the variable-coefficient symmetric
four-colour sweep in one pass) alone on the cell's own fine planes, in
f32 as the solver's hierarchy holds them, with u and b the benchmark
makes from the seed: its least time (``var_roofline.var_sweep``: each
input read once, u written once, at the card's peaks) over its time,
CUDA events over warm launches, in percent. None off the card or
without planes."""

import torch

from amg_tpu_torch.ops.kernels import fused_gs4_sweep
from amg_tpu_torch.sparse.stencil import Stencil2D
from portbench import kernels, roofline, var_roofline


def read(run):
    planes = (run.inputs or {}).get("planes")
    if run.device.type != "cuda" or planes is None:
        return None
    n = int(planes.shape[-1])
    S = Stencil2D(side=n, c=planes.to(torch.float32).contiguous())
    g = kernels.generator(run)
    u, b = (torch.randn((n, n), generator=g, dtype=torch.float32,
                        device=run.device) for _ in range(2))
    seconds = kernels.time_launches(
        lambda: fused_gs4_sweep(S, u, b, 1.0, True), run.device)
    least, _ = roofline.least_seconds(torch.cuda.get_device_name(run.device),
                                      *var_roofline.var_sweep(n))
    return 100.0 * least / seconds
