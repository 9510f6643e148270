"""The share of the traced stretch of the mix (``harness.trace_mix``) in
which the card had no work: 1 - busy / window of the profiler's trace.
A graph launch is busy from its first recorded operation to its last,
with its conditional body, which CUPTI does not record, between them;
so the gaps between a graph's own kernels count as busy, and this is the
time that the host leaves the card without work. Nothing without a
trace."""


def read(run):
    if not run.trace:
        return None
    return 1.0 - run.trace["busy_s"] / run.trace["window_s"]
