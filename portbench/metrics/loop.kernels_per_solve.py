"""Kernel nodes a solve: the kernel nodes the solve graphs executed (the
port's own kernels, the loop's condition kernel and the plain ops; the
program's tracing stamps excluded) over the solves, both counted by the
program (``amg_tpu_torch.utils.tracing``: each captured piece's nodes by
kind times its runs, read off the graph's device counts; a solve is one
replay of a loop program), over every solve of the run: the window's,
the set-up's warm-up solves and the traced stretch's. None off the card,
or where the program keeps no such counter."""


def read(run):
    if run.device.type != "cuda":
        return None
    try:
        from amg_tpu_torch.utils import tracing
    except ImportError:
        return None
    counts = (getattr(run, "program", None) or tracing.report())["counters"]
    if not counts["solves"]:
        return None
    return counts["kernels"] / counts["solves"]
