"""Seconds of set-up in the Galerkin chain of a variable-coefficient
hierarchy: the program's ``setup.galerkin_planes`` host span
(``amg_tpu_torch.utils.tracing``: the plane contraction
``rap_stencil_planes`` level by level on the card, waited for), summed
over the run's process. None off the card, or where the program has no
such span."""


def read(run):
    if run.device.type != "cuda":
        return None
    try:
        from amg_tpu_torch.utils import tracing
    except ImportError:
        return None
    setup = (getattr(run, "program", None) or tracing.report())["setup"]
    return setup.get("setup.galerkin_planes")
