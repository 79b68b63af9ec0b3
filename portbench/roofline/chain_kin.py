"""``chain_warp_kernel<true>`` (legkilo_torch/csrc/chain_stats.cu), the
fused chain's kinematic branch: one warp a replica, one launch for the
whole fleet."""

KERNEL = r"chain_warp_kernel<true>"


def count(shapes):
    """Bytes: the state, clocks and events (params 40, clocks 2, rot 9, lin
    27, cov 900, bucket rows 3 a bucket, per event slot time, gate, acc 3,
    gyr 3, foot pos 12, foot vel 12, contact 4), the match's statistics
    (40 x 40 a bucket) and the nine outputs (rot 9, pos 3, the two pose
    covariance blocks 9 each and the match count a bucket; the final rot,
    lin, cov and clocks), fp32, once each.  Operations: every event slot
    runs a predict (~4.5k) and the kinematic update (~116k: H P H^T, the
    nested-Schur 18x18 inverse, the 30x18 gain, the 30x30 downdate), gated
    or not; every bucket a predict and the point update from its
    statistics (~17k)."""
    b, nb, k = shapes["B"], shapes["nb"], shapes["k"]
    inputs = 40 + 2 + 9 + 27 + 900 + 3 * nb + nb * k * (1 + 1 + 3 + 3 + 12 + 12 + 4) + nb * 1600
    outputs = nb * (9 + 3 + 9 + 9 + 1) + 9 + 27 + 900 + 2
    flops = nb * (k * (4.5e3 + 116e3) + 4.5e3 + 17e3)
    return b * 4 * (inputs + outputs), b * flops
