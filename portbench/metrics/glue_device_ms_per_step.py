"""Device milliseconds a fleet step of every operation that is not one of
the port's own kernels (portbench/kernels.json): the eager glue's index,
copy, sort, scatter and elementwise kernels, copies and sets."""


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    glue = sum(e - s for name, s, e in run.trace.ops if not run.is_port_kernel(name))
    return glue / 1e6 / run.steps
