"""Seconds from the start of the process to the first timed call: imports,
the CUDA context, the kernel library (built on a checkout's first run,
loaded after), the sim, the packets, the fleet's set-up and the warm-up."""


def read(run):
    return run.setup_s
