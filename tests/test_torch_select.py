"""The one-launch select kernel's order of work, rehearsed in plain torch on the CPU.

``csrc/match_geom.cu`` runs select as one launch: a block a bucket gathers
its bucket's rows in ascending order with an ordered ballot/popc scan over
bidx, computes each row's candidates one thread a candidate, selects with
eight lanes a row (reachable as a prefix product over the chain's levels,
each chain's pick as a first-wins argmax over prob), and sums s40 over its
own rows in row order; blocks for the rows in no bucket run the row pass
only.  Where that order departs from ``select_plain``, this file writes the
same steps in plain torch and holds them to it:

- the candidate records, the prefix-product reachable and the first-wins
  pick give ``select_plain``'s rows exactly, with ties of prob between
  levels, unreachable levels, nothing found and rows masked off;
- the scan (the kernel's own constants, read from the CUDA source as text)
  gives each bucket its rows in ascending order, in groups of at most one
  group's rows, and the rows in no bucket to the blocks that cover them;
- sums of x_i w x_j taken row by row in that order (``torch.addcmul``),
  upper triangle mirrored, give ``select_plain``'s s40 at rel 1e-5;
- the feature codes in the source give ``select_plain``'s features.

The kernel itself is held against ``select_plain`` on the card
(tests/test_torch_cuda.py, chip_smoke.py); ``select_plain`` against the
JAX package's Pallas kernel in tests/test_torch_kernels.py.
"""

import os
import re

import numpy as np
import pytest
import torch

import chip_smoke as cs
from legkilo_torch.ops import match_geom as mg
from torch_util import one_thread  # noqa: F401

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "legkilo_torch", "csrc",
                   "match_geom.cu")


def _source():
    with open(SRC) as fh:
        return fh.read()


def _const(name):
    """An ``int`` constant of the select kernel, evaluated from the source."""
    consts = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", _source()))

    def ev(expr):
        expr = re.sub(r"\b(k\w+)\b", lambda m: str(ev(consts[m.group(1)])), expr)
        return int(eval(expr, {"__builtins__": {}}))  # integer products of other constants

    return ev(consts[name])


def _inputs(c, levels, nb, seed):
    """chip_smoke's select inputs at C rows on the CPU."""
    rng = np.random.default_rng(seed)
    kargs = cs.keys_inputs(torch, "cpu", rng, c=c, levels=levels)
    return cs.select_inputs(torch, "cpu", rng, mg.keys_plain(*kargs, levels, 1 << 12), nb=nb, levels=levels), rng


def _special_rows(args, levels):
    """Rows 0-99 of ``args`` rewritten in place (chain 0, levels 0 and 1):
    0-19 two levels tie on prob (the same plane and centre, the normal
    negated, no plane/normal covariance cross terms; found 4, is_plane 0.5,
    so both levels pass and level 1 stays reachable; no other candidate
    found on 0-59); 20-39 level 0 not
    found and level 1 a passing plane (unreachable); 40-59 level 0 a plane
    whose range gate fails, level 1 a passing plane (unreachable); 60-79
    nothing found on any candidate; 80-99 masked off."""
    piw, vc, plane, flags, mask = args[1], args[3], args[4], args[5], args[6]
    nc = 2 * levels
    pl = plane.view(nc, 31, -1)
    rows = slice(0, 60)
    for m in (0, 1):
        vc[3 * m:3 * m + 3, rows] = vc[0:3, rows]
        pl[m, 0:3, rows] = piw[3:6, rows] - vc[0:3, rows]      # the point on the plane
        pl[m, 3:6, rows] = pl[0, 3:6, rows] * (1.0 if m == 0 else -1.0)
        pl[m, 9, rows] = 0.3
        for i in range(3):
            for j in range(3, 6):
                pl[m, 10 + mg._sym21(i, j), rows] = 0.0
        if m == 1:
            pl[1, 10:31, rows] = pl[0, 10:31, rows]
    flags[2:nc, 0:60] = 0.0                                     # no other candidate found
    flags[0:2, 0:20], flags[nc:nc + 2, 0:20] = 4.0, 0.5
    flags[0, 20:40], flags[1, 20:40], flags[nc + 1, 20:40] = 0.0, 1.0, 1.0
    flags[0:2, 40:60], flags[nc:nc + 2, 40:60] = 1.0, 1.0
    pl[0, 0:3, 40:60] += 10.0                                   # 10 m off: the range gate fails
    flags[0:nc, 60:80] = 0.0
    mask[0, 80:100] = 0.0
    return args


def candidate_records(par, piw, bcov, vc, plane, flags, levels):
    """One record a candidate m (chain * L + level), as a thread of the
    kernel's candidate step leaves it: found, isp, found * isp * gates,
    prob, sl, n, centre, each [2L, C]; the arithmetic is select_plain's."""
    s = par.reshape(-1)
    sigma_num, radius_k = s[0], s[1]
    nc = 2 * levels
    pw = piw[3:6][None]                                   # [1, 3, C]
    wc = [bcov[i] for i in range(9)]
    pr = plane.view(nc, 31, -1)
    found, isp = flags[0:nc], flags[nc:2 * nc]
    cen = [vc.view(nc, 3, -1)[:, i] + pr[:, i] for i in range(3)]
    n3 = [pr[:, 3], pr[:, 4], pr[:, 5]]
    rel = [pw[:, i] - cen[i] for i in range(3)]
    dist = torch.abs(n3[0] * rel[0] + n3[1] * rel[1] + n3[2] * rel[2])
    d2c = rel[0] * rel[0] + rel[1] * rel[1] + rel[2] * rel[2]
    range_dis2 = torch.clamp(d2c - dist * dist, min=0.0)
    rk = radius_k * pr[:, 9]
    gate_range = (range_dis2 <= rk * rk).to(torch.float32)
    j6 = rel + [-n3[0], -n3[1], -n3[2]]
    zero = torch.zeros_like(dist)
    sig = zero
    for i in range(6):
        row = zero
        for jj in range(6):
            row = row + pr[:, 10 + mg._sym21(i, jj)] * j6[jj]
        sig = sig + j6[i] * row
    for k in range(9):
        sig = sig + n3[k // 3] * wc[k] * n3[k % 3]
    sig = torch.clamp(sig, min=1e-12)
    gate_sigma = (dist < sigma_num * torch.sqrt(sig)).to(torch.float32)
    prob = torch.rsqrt(sig) * torch.exp(-0.5 * dist * dist / sig)
    ok0 = found * isp * gate_range * gate_sigma
    sl = sig - mg._nwn(n3, wc)
    return found, isp, ok0, prob, sl, torch.stack(n3), torch.stack(cen)


def select_by_candidates(par, piw, bcov, vc, plane, flags, mask, levels):
    """out[0:46] from the candidate records: reachable as the prefix product
    of the chain's earlier levels' found * (1 - isp), each chain's pick the
    first level of largest prob among ok > 0.5, then the kernel's choice
    of chain, weight and features."""
    found, isp, ok0, prob, sl, n3, cen = candidate_records(par, piw, bcov, vc, plane, flags, levels)
    ratio = par.reshape(-1)[2]
    ws = [bcov[9 + i] for i in range(9)]
    c = piw.shape[1]
    matched_ch, pick_ch = [], []
    for ch in range(2):
        lv = slice(ch * levels, (ch + 1) * levels)
        reach = [torch.ones(c)]
        for k in range(levels - 1):
            reach.append(reach[-1] * found[lv][k] * (1.0 - isp[lv][k]))
        ok = ok0[lv] * torch.stack(reach)                          # [L, C]
        key = torch.where((ok > 0.5) & (prob[lv] > -3.0e38), prob[lv], torch.full_like(ok, -torch.inf))
        best = key.max(dim=0).values
        hit = (key == best) & torch.isfinite(key)
        first = torch.where(hit.any(dim=0), hit.to(torch.int64).argmax(dim=0), torch.full_like(best, -1).long())
        matched_ch.append(torch.clamp(ok.max(dim=0).values, min=0.0))
        pick_ch.append(first)
    sel = ((1.0 - matched_ch[0]) * matched_ch[1]) > 0.5
    matched = torch.maximum(matched_ch[0], matched_ch[1]) * mask[0]
    pick = torch.where(sel, pick_ch[1], pick_ch[0])
    m = torch.clamp(torch.where(sel, levels + pick, pick), min=0)
    cols = torch.arange(c)
    n = [torch.where(pick >= 0, n3[i][m, cols], torch.zeros(c)) for i in range(3)]
    cc = [torch.where(pick >= 0, cen[i][m, cols], torch.zeros(c)) for i in range(3)]
    s_l = torch.where(pick >= 0, sl[m, cols], torch.zeros(c))
    r_meas = ratio * (s_l + mg._nwn(n, ws))
    w = matched / (r_meas + mg._R_JITTER)
    p = [piw[0], piw[1], piw[2]]
    zero = torch.zeros(c)
    sp = [zero, -p[2], p[1], p[2], zero, -p[0], -p[1], p[0], zero]
    feat = [n[k] * sp[3 * i + b] for i in range(3) for k in range(3) for b in range(3)]
    feat += n + [n[k] * p[a] for k in range(3) for a in range(3)]
    feat.append(n[0] * cc[0] + n[1] * cc[1] + n[2] * cc[2])
    return torch.stack([matched, w, r_meas, matched, zero, zero] + feat), (ok0, prob, found, isp)


@pytest.mark.parametrize("c,levels,nb", [(512, 3, 5), (448, 2, 4), (384, 4, 3), (320, 1, 2)])
def test_candidate_selection_matches_plain(c, levels, nb):
    """Lane-per-candidate selection gives select_plain's rows bit for bit."""
    args, _ = _inputs(c, levels, nb, seed=c + levels)
    args = _special_rows(args, levels) if levels >= 2 else args
    got, (ok0, prob, found, isp) = select_by_candidates(*args[:7], levels)
    ref = mg.select_plain(*args, levels, nb)[0]
    assert torch.equal(got, ref)
    if levels >= 2:
        # The cases are there: ties between levels 0 and 1 passing on rows
        # 0-19 (level 0 wins: its normal, not the negated one), level 1
        # unreachable on 20-59, no match on 60-79, masked rows on 80-99.
        assert bool((prob[0, 0:20] == prob[1, 0:20]).all()) and bool((ok0[0:2, 0:20] > 0.5).all())
        assert torch.equal(got[6 + 27:6 + 30, 0:20], args[4].view(2 * levels, 31, -1)[0, 3:6, 0:20])
        assert bool((ok0[1, 20:60] > 0.5).all()) and not bool(got[0, 20:40].any())
        assert not bool(got[0, 60:100].any()) and not bool(got[6:, 60:80].any())
    assert 0.0 < float(ref[0, 100:c - 200].mean()) < 1.0   # both gate outcomes, unedited rows


def gather_rows(bidx, nb):
    """The kernel's scan, block by block: {block: [group, ...]}, a group the
    rows (ascending) that one row pass takes.  Block b < nb takes the rows
    of bucket b over all of [0, C); block nb + k the rows in no bucket in
    its span of kOrphanSpan rows.  Each scan step reads kScanPerThread
    words a thread; a row's place in its block's list is the count of
    flagged rows before it in (word, warp, lane) order: the exclusive scan
    of the warps' ballot counts plus the popc of the lanes below it."""
    threads, per, group, span = (_const(k) for k in ("kThreads", "kScanPerThread", "kGroup", "kOrphanSpan"))
    c = bidx.shape[0]
    v = bidx.to(torch.float32)
    inb = (v > -1.0) & (v < float(nb))
    blocks = {}
    for blk in range(nb + (c + span - 1) // span):
        lo, hi = (0, c) if blk < nb else ((blk - nb) * span, min(c, (blk - nb + 1) * span))
        total, rows_at = 0, {}
        for base in range(lo, hi, threads * per):
            r = base + torch.arange(per)[:, None] * threads + torch.arange(threads)[None, :]   # [word, thread]
            live = r < hi
            rr = torch.clamp(r, max=c - 1)
            mine = inb[rr] & (v[rr].to(torch.int64) == blk) if blk < nb else ~inb[rr]
            f = live & mine
            warp_cnt = f.view(per, threads // 32, 32).sum(-1).reshape(-1)       # (word, warp) order
            ex = torch.cumsum(warp_cnt, 0) - warp_cnt
            below = torch.cumsum(f.view(per, threads // 32, 32).to(torch.int64), -1) - f.view(
                per, threads // 32, 32).to(torch.int64)
            pos = total + ex.view(per, threads // 32, 1) + below
            for p_, row in zip(pos[f.view(per, threads // 32, 32)].tolist(), r[f].tolist()):
                rows_at[p_] = row
            total += int(warp_cnt.sum())
        assert sorted(rows_at) == list(range(total))
        lst = [rows_at[k] for k in range(total)]
        blocks[blk] = [lst[g:g + group] for g in range(0, total, group)]
    return blocks


@pytest.mark.parametrize("c,nb", [(3584, 28), (5000, 9), (300, 5)])
def test_scan_gathers_each_bucket_in_order(c, nb):
    """A shuffled bidx (with rows in no bucket: -1, nb, nb + 0.5, NaN, a
    fraction below 0, and a bucket of more rows than a group holds): each
    bucket block gets exactly its rows (the int64 cast of bidx), ascending,
    in groups of at most kGroup; the rows in no bucket go to the blocks
    whose span holds them."""
    rng = np.random.default_rng(c)
    b = rng.integers(0, nb, size=c).astype(np.float32)
    b[rng.random(c) < 0.06] = nb
    b[: c // 5] = 1.0                        # bucket 1: past one group at C 3584 and 5000
    b[7], b[11], b[13], b[17], b[19] = -1.0, np.nan, nb + 0.5, -0.5, nb - 0.5
    bidx = torch.tensor(rng.permutation(b))
    blocks = gather_rows(bidx, nb)
    group, span = _const("kGroup"), _const("kOrphanSpan")
    tgt = cs.bucket_targets(torch, bidx, nb)
    for k in range(nb):
        rows = [r for g in blocks[k] for r in g]
        assert rows == torch.nonzero(tgt == k)[:, 0].tolist()
        assert all(0 < len(g) <= group for g in blocks[k])
    orphans = [r for blk in range(nb, len(blocks)) for g in blocks[blk] for r in g]
    assert orphans == torch.nonzero(tgt == nb)[:, 0].tolist()
    for blk in range(nb, len(blocks)):
        assert all((blk - nb) * span <= r < (blk - nb + 1) * span for g in blocks[blk] for r in g)
    if c >= 3584:
        assert len(blocks[1]) >= 3


def test_tile_sums_in_row_order_match_plain():
    """s40 as the kernel sums it: for each bucket, its rows in the scan's
    order, s += (x w) x^T one row at a time (the kernel's fma(x_i w, x_j, s)
    a 4x4 tile at a time), the upper triangle mirrored; rel 1e-5 of
    select_plain's s40."""
    nb = 6
    args, rng = _inputs(1024, 3, nb, seed=5)
    args[7] = args[7][:, torch.as_tensor(rng.permutation(1024))].contiguous()
    out, s40, _ = mg.select_plain(*args, 3, nb)
    x, w = out[6:46], out[1]
    blocks = gather_rows(args[7][0], nb)
    got = torch.zeros(nb, 40, 40)
    for k in range(nb):
        s = torch.zeros(40, 40)
        for g in blocks[k]:
            for r in g:
                s = torch.addcmul(s, (x[:, r] * w[r])[:, None], x[None, :, r])
        up = torch.triu(s)
        got[k] = up + torch.triu(s, diagonal=1).T
        assert len(blocks[k]) == 1 and 0 < len(blocks[k][0]) < 256
    assert cs.rel_err(got.reshape(nb * 40, 40), s40) <= 1e-5


def test_feature_codes_give_plain_features():
    """The kernel builds feature f of a row from a code (byte q of word t of
    kFeatCodes for f = 8t + q): n[a] times p[b], negated, times 0 or 1, or
    n . c.  Decoded from the source, the codes give select_plain's 40
    features bit for bit (n . c is the plain version's own)."""
    words = re.search(r"kFeatCodes\[5\] = \{([^}]*)\}", _source()).group(1)
    words = [int(w.strip().rstrip("ul"), 16) for w in words.replace("ull", "").split(",")]
    bits = {k: int(v) for k, v in re.findall(r"(kFeat\w+) = (\d+)", _source())}
    neg, zero, one, dot = (bits[k] for k in ("kFeatNeg", "kFeatZero", "kFeatOne", "kFeatDot"))
    args, _ = _inputs(512, 3, 4, seed=9)
    out = mg.select_plain(*args, 3, 4)[0]
    n, p = out[33:36], args[1][0:3]
    for f in range(40):
        code = words[f // 8] >> (8 * (f % 8)) & 0xFF
        if code & dot:
            assert f == 39
            continue
        factor = (torch.ones_like(p[0]) if code & one else torch.zeros_like(p[0]) if code & zero
                  else -p[code >> 2 & 3] if code & neg else p[code >> 2 & 3])
        assert torch.equal(n[code & 3] * factor, out[6 + f]), f


def test_select_launch_is_one_kernel_without_atomics():
    """select_launch launches once (one ``<<<``); the select kernel uses no
    atomics; the two kernels of the two-launch design are gone."""
    src = _source()
    start = src.index("LK_API int select_launch")
    body = src[start:src.index("\n}\n", start)]
    assert body.count("<<<") == 1 and "select_kernel<<<" in body
    sel = src[src.index("// ---------------------------------------------------------------- select --"):]
    assert "atomic" not in re.sub(r"//[^\n]*", "", sel)   # code, not comments
    assert "select_rows_kernel" not in src and "select_sums_kernel" not in src
