"""``chain_warp_kernel<true>``'s least possible time at the cell's shapes
over its mean traced time (portbench/roofline/chain_kin.py)."""

from portbench.roofline import chain_kin, share


def read(run):
    return share(run, chain_kin)
