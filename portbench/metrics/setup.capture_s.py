"""Seconds of set-up in the capture of the solve graphs: the program's
``setup.capture`` host spans (``amg_tpu_torch.utils.tracing``: one a
program, each the pieces' warm-up, their capture and the graph's
instantiation; the kernel library's build or load is not in them),
summed over the run's process. None off the card, or
where the program has no such span."""


def read(run):
    if run.device.type != "cuda":
        return None
    try:
        from amg_tpu_torch.utils import tracing
    except ImportError:
        return None
    setup = (getattr(run, "program", None) or tracing.report())["setup"]
    return setup.get("setup.capture")
