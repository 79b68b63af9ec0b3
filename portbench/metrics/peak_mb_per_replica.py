"""``torch.cuda.max_memory_allocated()`` over set-up and the window, less
the memory held before the fleet was built, over the replicas, in MB
(10^6 bytes)."""


def read(run):
    if run.peak_bytes is None:
        return None
    return (run.peak_bytes - run.mem0_bytes) / run.batch / 1e6
