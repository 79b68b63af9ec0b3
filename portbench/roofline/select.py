"""``select_kernel`` (legkilo_torch/csrc/match_geom.cu): one launch for the
whole fleet, C = match_cap rows and NB buckets a replica."""

KERNEL = r"\bselect_kernel\b"


def count(shapes):
    """Inputs: par [8] and the rows piw [6], bcov [18], vc [6L], plane
    [62L], flags [4L], mask [1], bidx [1] a row; outputs: [46] a row, s40
    [NB, 40, 40] and the counts [NB, 128]; fp32.  Operations: a row's 6
    candidates (~200 each), its features (~80) and its s40 terms (~820
    for each of 3 products)."""
    b, c, nb, lv = shapes["B"], shapes["match_cap"], shapes["nb"], shapes["levels"]
    rows = 6 + 18 + 6 * lv + 62 * lv + 4 * lv + 1 + 1 + 46
    one = 4 * (8 + c * rows + nb * 40 * 40 + nb * 128)
    return b * one, b * c * (6 * 200 + 80 + 820 * 3)
