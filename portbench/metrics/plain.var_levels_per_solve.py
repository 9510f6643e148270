"""Visits of variable-coefficient levels that the plain ops ran, a solve:
the program's ``var_levels_plain`` counter (``amg_tpu_torch.utils.tracing``:
each visit of a level without constant weights, the coarsest excluded,
that no kernel swept; masked, packed-var, strided or Chebyshev; credited
per graph replay) over its solves, every solve of the run. None off the
card, or where the program keeps no such counter."""


def read(run):
    if run.device.type != "cuda":
        return None
    try:
        from amg_tpu_torch.utils import tracing
    except ImportError:
        return None
    counts = (getattr(run, "program", None) or tracing.report())["counters"]
    if "var_levels_plain" not in counts or not counts["solves"]:
        return None
    return counts["var_levels_plain"] / counts["solves"]
