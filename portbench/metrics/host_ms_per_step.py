"""Host milliseconds a fleet step inside the step call (``pb.step``: from
the call until it returns, before the read-back: the enqueue), summed over
the traced window and divided by its fleet steps (a chunked call counts
its scans)."""


def read(run):
    if run.trace is None:
        return None
    total = sum(t1 - t0 for name, t0, t1 in run.window.spans if name == "pb.step")
    return total * 1e3 / run.steps
