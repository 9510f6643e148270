"""V-cycles a solve: the refines that the entry point's stats report,
times the solver's V-cycles a refine (the start excluded), the mean over
the window's solves."""


def read(run):
    if not run.records:
        return None
    refines = sum(r.refines for r in run.records) / len(run.records)
    return refines * run.cycles_per_refine
