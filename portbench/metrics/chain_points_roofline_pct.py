"""``chain_points_warp_kernel<true>``'s least possible time at the cell's
shapes over its mean traced time (portbench/roofline/chain_points.py)."""

from portbench.roofline import chain_points, share


def read(run):
    return share(run, chain_points)
