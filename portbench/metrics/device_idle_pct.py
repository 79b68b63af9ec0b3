"""Share of the traced window in which no operation ran on the card, from
the union of the device operations' intervals."""

from portbench import trace


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    return 100.0 * (1.0 - trace.busy_s(run.trace) / trace.window_s(run.trace))
