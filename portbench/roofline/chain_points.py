"""``chain_points_warp_kernel<true>`` (legkilo_torch/csrc/chain_points.cu),
the per-point chain's kinematic branch: one warp a replica, one launch
for the whole fleet."""

KERNEL = r"chain_points_warp_kernel<true>"


def count(shapes):
    """Bytes: the state, clocks and events (params 40, clocks 2, rot 9, lin
    27, cov 900, per bucket time and gate, per event slot time, gate, acc
    3, gyr 3, foot pos 12, foot vel 12, contact 4), the match rows (point
    3, normal 3, offset, radius, mask a row, P a bucket) and the nine
    outputs, fp32, once each.  Operations a bucket: a predict ~4.5k, the
    kinematic update ~116k a slot (IMU ~14k), the point update ~17k, and
    ~110 a match row."""
    b, nb, k, p = shapes["B"], shapes["nb"], shapes["k"], shapes["p"]
    kin = shapes["use_kin"]
    inputs = 40 + 2 + 9 + 27 + 900 + 2 * nb + nb * k * (1 + 1 + 3 + 3 + 12 + 12 + 4) + nb * p * 9
    outputs = nb * (9 + 3 + 9 + 9 + 1) + 9 + 27 + 900 + 2
    ev = 4.5e3 + (116e3 if kin else 14e3)
    flops = nb * (k * ev + 4.5e3 + 17e3) + nb * p * 110.0
    return b * 4 * (inputs + outputs), b * flops
