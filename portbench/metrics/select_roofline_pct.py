"""``select_kernel``'s least possible time at the cell's shapes over its
mean traced time (portbench/roofline/select.py)."""

from portbench.roofline import select, share


def read(run):
    return share(run, select)
