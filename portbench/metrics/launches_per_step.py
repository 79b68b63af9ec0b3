"""Device kernels, copies and sets in the traced window a fleet step (the
check's snapshots, some hundreds of small operations a trial, included)."""


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    return len(run.trace.ops) / run.steps
