"""Milliseconds the host spends in the entry point that launches a solve's
CUDA graph and returns before the solve ends (``solve_ir_device``): the
host clock around each call of the window, the median."""

import statistics


def read(run):
    if not run.records:
        return None
    return 1e3 * statistics.median(r.t_ret - r.t_call for r in run.records)
