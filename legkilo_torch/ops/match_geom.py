"""Match-phase kernels of the deferred pipeline: CUDA kernels + plain versions.

Replace the JAX package's Pallas kernels in ops/pallas/match_geom.py with
the same row contracts, in the transposed [component, row] layout:

``keys_call`` (``_keys_kernel`` :74, ``keys_call`` :454)
    par [64] (ext_r 9, ext_t 3, level sizes 4 @12, cov_rr 9 @16,
    cov_pp 9 @25, dept_err @34, beam_err @35), pts [3,C], rb [9,C], pb [3,C]
    -> piw [6,C] (p_i, p_w), covs [27,C] (full world cov, sensor-only
    world cov, LiDAR-frame sensor cov), keys [6L,C] int32 (own chain, then
    neighbour chain), vc [6L,C] candidate voxel centres, idx0 [2L,C] int32
    probe starts (level * capacity + hash).

``select_call`` (``_select_kernel`` :254, ``select_call`` :487)
    par [8] (sigma_num, radius_k, lidar_point_meas_ratio), piw [6,C],
    bcov [18,C], vc [6L,C], plane [62L,C] (gathered plane rows),
    flags [4L,C] (found, is_plane), mask [1,C], bidx [1,C] (float bucket;
    n_buckets for padding rows)
    -> out [46,C] (matched, w, r, matched, 0, 0, X(40)), s40 [NB*40,40],
    nm [NB,128] (every column is the bucket's match count).

On a CUDA tensor each wrapper launches ``csrc/match_geom.cu`` (keys as a
block of four warps a tile of 32 rows, each warp one part of every row's
work; select as one launch: a block a bucket, which gathers its own rows,
selects their planes and sums their statistics, and blocks for the rows in
no bucket); on a CPU tensor it runs the plain version, which repeats the
kernel's arithmetic in the same order.

A fleet of B replicas is one launch of each kernel: par gains a leading B
(a row a replica) and the C rows are the replicas' C / B rows side by
side.  keys' probe starts then name the replica's own tables, segment
``r * L + level`` of the fleet's flat map; select's ``n_buckets`` are the
replicas' buckets side by side, replica r's rows naming its own buckets
``r * NB/B ...`` (or none).  The plain versions run the replicas one after
another.
"""

from __future__ import annotations

import math

import torch

from . import _build

F32 = torch.float32
I32 = torch.int32
_DEG2RAD = math.pi / 180.0
_R_JITTER = 1e-4
_HASH_P = (73856093, 471943, 83492791)
_MASK32 = 0xFFFFFFFF

_P_EXT_R, _P_EXT_T, _P_SIZES, _P_COV_RR, _P_COV_PP = 0, 9, 12, 16, 25
_P_DEPT, _P_BEAM = 34, 35


def _sym21(i: int, j: int) -> int:
    i, j = min(i, j), max(i, j)
    return i * 6 + j - (i * (i + 1)) // 2


def hash_keys(k0: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor, capacity: int) -> torch.Tensor:
    """Spatial hash of int keys (eigen_types.hpp:74-82) on uint32 with
    wrap-around, computed in int64: (k & 0xFFFFFFFF) * prime < 2^59."""
    h = None
    for k, prime in zip((k0, k1, k2), _HASH_P):
        term = ((k.to(torch.int64) & _MASK32) * prime) & _MASK32
        h = term if h is None else h ^ term
    return (h & (capacity - 1)).to(I32)


def _sandwich(m, c):
    """Rows of m @ c @ m^T for lists of 9 rows (or scalars)."""
    t = [m[3 * i] * c[0][j] + m[3 * i + 1] * c[1][j] + m[3 * i + 2] * c[2][j]
         for i in range(3) for j in range(3)]
    return [t[3 * i] * m[3 * j] + t[3 * i + 1] * m[3 * j + 1] + t[3 * i + 2] * m[3 * j + 2]
            for i in range(3) for j in range(3)]


def keys_plain(par, pts_t, rb_t, pb_t, levels: int, capacity: int):
    """Plain PyTorch version of the keys kernel (same contract)."""
    if par.dim() == 2:  # a fleet: the replicas one after another
        rpr = pts_t.shape[1] // par.shape[0]
        outs = []
        for r in range(par.shape[0]):
            cols = slice(r * rpr, (r + 1) * rpr)
            out = list(keys_plain(par[r], pts_t[:, cols], rb_t[:, cols], pb_t[:, cols], levels,
                                  capacity))
            out[4] = out[4] + r * levels * capacity  # the replica's own tables
            outs.append(out)
        return tuple(torch.cat(xs, dim=1) for xs in zip(*outs))
    s = par.reshape(-1)
    px, py, pz = pts_t[0], pts_t[1], pts_t[2]
    e = [s[_P_EXT_R + i] for i in range(9)]
    pix = e[0] * px + e[1] * py + e[2] * pz + s[_P_EXT_T + 0]
    piy = e[3] * px + e[4] * py + e[5] * pz + s[_P_EXT_T + 1]
    piz = e[6] * px + e[7] * py + e[8] * pz + s[_P_EXT_T + 2]
    r = [rb_t[i] for i in range(9)]
    pw = [r[3 * i] * pix + r[3 * i + 1] * piy + r[3 * i + 2] * piz + pb_t[i] for i in range(3)]
    piw = torch.stack([pix, piy, piz] + pw)

    zsafe = torch.where(torch.abs(pz) < 1e-8, torch.full_like(pz, 1e-4), pz)
    rng = torch.sqrt(px * px + py * py + zsafe * zsafe)
    inv_rng = 1.0 / torch.clamp(rng, min=1e-12)
    dx, dy, dz = px * inv_rng, py * inv_rng, zsafe * inv_rng
    dept = s[_P_DEPT]
    range_var = dept * dept
    tsd = torch.sin(s[_P_BEAM] * _DEG2RAD)
    tangent_var = tsd * tsd
    b1z = -(dx + dy) / torch.where(torch.abs(dz) < 1e-12, torch.full_like(dz, 1e-12), dz)
    n1 = 1.0 / torch.sqrt(1.0 + 1.0 + b1z * b1z)
    b1x, b1y, b1z = n1, n1, b1z * n1
    c2x = b1y * dz - b1z * dy
    c2y = b1z * dx - b1x * dz
    c2z = b1x * dy - b1y * dx
    n2 = 1.0 / torch.sqrt(torch.clamp(c2x * c2x + c2y * c2y + c2z * c2z, min=1e-24))
    b2x, b2y, b2z = c2x * n2, c2y * n2, c2z * n2
    a = [
        [rng * (-dz * b1y + dy * b1z), rng * (-dz * b2y + dy * b2z)],
        [rng * (dz * b1x - dx * b1z), rng * (dz * b2x - dx * b2z)],
        [rng * (-dy * b1x + dx * b1y), rng * (-dy * b2x + dx * b2y)],
    ]
    d3 = [dx, dy, dz]
    bc = [[range_var * d3[i] * d3[j] + tangent_var * (a[i][0] * a[j][0] + a[i][1] * a[j][1])
           for j in range(3)] for i in range(3)]

    re = [r[3 * i] * e[j] + r[3 * i + 1] * e[3 + j] + r[3 * i + 2] * e[6 + j]
          for i in range(3) for j in range(3)]
    zero = torch.zeros_like(px)
    sk = [zero, -piz, piy, piz, zero, -pix, -piy, pix, zero]
    rc = [r[3 * i] * sk[j] + r[3 * i + 1] * sk[3 + j] + r[3 * i + 2] * sk[6 + j]
          for i in range(3) for j in range(3)]
    crr = [[s[_P_COV_RR + 3 * i + j] for j in range(3)] for i in range(3)]
    w1 = _sandwich(re, bc)
    w2 = _sandwich(rc, crr)
    wc = [w1[k] + w2[k] + s[_P_COV_PP + k] for k in range(9)]
    covs = torch.stack(wc + w1 + [bc[i][j] for i in range(3) for j in range(3)])

    key_rows, vc_rows, idx_rows = [], [], []
    for chain in range(2):
        for lvl in range(levels):
            size = s[_P_SIZES + lvl]
            inv_size = 1.0 / size
            ks = [torch.floor(pw[i] * inv_size) for i in range(3)]
            if chain == 1:
                quarter = size * 0.25
                for i in range(3):
                    rel = pw[i] - (ks[i] + 0.5) * size
                    off = (rel > quarter).to(F32) - (rel < -quarter).to(F32)
                    ks[i] = ks[i] + off
            ki = [k.to(I32) for k in ks]
            key_rows += ki
            vc_rows += [(ks[i] + 0.5) * size for i in range(3)]
            idx_rows.append(hash_keys(*ki, capacity) + lvl * capacity)
    return piw, covs, torch.stack(key_rows), torch.stack(vc_rows), torch.stack(idx_rows)


def keys_call(par, pts_t, rb_t, pb_t, levels: int, capacity: int):
    """The keys kernel on a CUDA tensor, its plain version on a CPU one;
    par [64], or [B, 64] for a fleet of B replicas of C / B rows each."""
    if par.device.type != "cuda":
        return keys_plain(par, pts_t, rb_t, pb_t, levels, capacity)
    C = pts_t.shape[1]
    batch = par.shape[0] if par.dim() == 2 else 1
    args = (par.reshape(-1), pts_t, rb_t, pb_t)
    for a, rows in zip(args[1:], (3, 9, 3)):
        if tuple(a.shape) != (rows, C):
            raise ValueError(f"keys_call: shape {tuple(a.shape)}, expected {(rows, C)}")
    if args[0].numel() != 64 * batch or C % batch or not 1 <= levels <= 4:
        raise ValueError("keys_call: par must hold 64 floats a replica, the rows split evenly "
                         "over the replicas and 1 <= levels <= 4")
    dev = _build.check_tensors("keys_call", args, [F32] * 4)
    outs = (
        torch.empty((6, C), dtype=F32, device=dev),
        torch.empty((27, C), dtype=F32, device=dev),
        torch.empty((6 * levels, C), dtype=I32, device=dev),
        torch.empty((6 * levels, C), dtype=F32, device=dev),
        torch.empty((2 * levels, C), dtype=I32, device=dev),
    )
    _build.launch("keys_launch", args + outs, [C, levels, capacity, batch])
    keys_call.launches += 1
    return outs


keys_call.launches = 0


def _nwn(n3, w):
    out = n3[0] * w[0] * n3[0]
    for k in range(1, 9):
        out = out + n3[k // 3] * w[k] * n3[k % 3]
    return out


def select_plain(par, piw_t, bcov_t, vc_t, plane_t, flags_t, mask_t, bidx_t,
                 levels: int, n_buckets: int):
    """Plain PyTorch version of the select kernel (same contract)."""
    if par.dim() == 2:  # a fleet: the replicas one after another
        return _select_plain_fleet(par, piw_t, bcov_t, vc_t, plane_t, flags_t, mask_t, bidx_t,
                                   levels, n_buckets)
    s = par.reshape(-1)
    sigma_num, radius_k, ratio = s[0], s[1], s[2]
    nc = 2 * levels
    pw = [piw_t[3], piw_t[4], piw_t[5]]
    wc = [bcov_t[i] for i in range(9)]
    ws = [bcov_t[9 + i] for i in range(9)]
    zero = torch.zeros_like(pw[0])

    chains = []
    for chain in range(2):
        best_prob = torch.full_like(zero, -3.0e38)
        b_matched, b_sl = zero, zero
        b_n, b_c = [zero] * 3, [zero] * 3
        reachable = torch.ones_like(zero)
        for lvl in range(levels):
            m = chain * levels + lvl
            pr = plane_t[m * 31 : (m + 1) * 31]
            found, isp = flags_t[m], flags_t[nc + m]
            cen = [vc_t[3 * m + i] + pr[i] for i in range(3)]
            n3 = [pr[3], pr[4], pr[5]]
            rel = [pw[i] - cen[i] for i in range(3)]
            dist = torch.abs(n3[0] * rel[0] + n3[1] * rel[1] + n3[2] * rel[2])
            d2c = rel[0] * rel[0] + rel[1] * rel[1] + rel[2] * rel[2]
            range_dis2 = torch.clamp(d2c - dist * dist, min=0.0)
            rk = radius_k * pr[9]
            gate_range = (range_dis2 <= rk * rk).to(F32)
            j6 = rel + [-n3[0], -n3[1], -n3[2]]
            sig = zero
            for i in range(6):
                row = zero
                for jj in range(6):
                    row = row + pr[10 + _sym21(i, jj)] * j6[jj]
                sig = sig + j6[i] * row
            for k in range(9):
                sig = sig + n3[k // 3] * wc[k] * n3[k % 3]
            sig = torch.clamp(sig, min=1e-12)  # PSD clamp (match_geom.py:339)
            gate_sigma = (dist < sigma_num * torch.sqrt(sig)).to(F32)
            prob = torch.rsqrt(sig) * torch.exp(-0.5 * dist * dist / sig)
            ok = found * isp * gate_range * gate_sigma * reachable
            bb = (ok > 0.5) & (prob > best_prob)
            best_prob = torch.where(bb, prob, best_prob)
            b_matched = torch.maximum(b_matched, ok)
            b_n = [torch.where(bb, n3[i], b_n[i]) for i in range(3)]
            b_c = [torch.where(bb, cen[i], b_c[i]) for i in range(3)]
            b_sl = torch.where(bb, sig - _nwn(n3, wc), b_sl)
            reachable = reachable * found * (1.0 - isp)
        chains.append((b_matched, b_n, b_c, b_sl))

    use_nbr = ((1.0 - chains[0][0]) * chains[1][0]) > 0.5
    matched = torch.maximum(chains[0][0], chains[1][0]) * mask_t[0]
    n_sel = [torch.where(use_nbr, chains[1][1][i], chains[0][1][i]) for i in range(3)]
    c_sel = [torch.where(use_nbr, chains[1][2][i], chains[0][2][i]) for i in range(3)]
    sl_sel = torch.where(use_nbr, chains[1][3], chains[0][3])
    r_meas = ratio * (sl_sel + _nwn(n_sel, ws))
    w = matched / (r_meas + _R_JITTER)

    p = [piw_t[0], piw_t[1], piw_t[2]]
    sp = [zero, -p[2], p[1], p[2], zero, -p[0], -p[1], p[0], zero]
    feat = [n_sel[c] * sp[3 * i + b] for i in range(3) for c in range(3) for b in range(3)]
    feat += n_sel
    feat += [n_sel[c] * p[a] for c in range(3) for a in range(3)]
    feat.append(n_sel[0] * c_sel[0] + n_sel[1] * c_sel[1] + n_sel[2] * c_sel[2])
    out = torch.stack([matched, w, r_meas, matched, zero, zero] + feat)

    # Per-bucket sums; padding rows (bidx == n_buckets) go to a dropped row.
    x = torch.stack(feat)                                   # [40, C]
    b = bidx_t[0].to(torch.int64)
    tgt = torch.where((b >= 0) & (b < n_buckets), b, torch.full_like(b, n_buckets))
    outer = (x * w).T[:, :, None] * x.T[:, None, :]         # [C, 40, 40]
    s40 = x.new_zeros((n_buckets + 1, 40, 40)).index_add_(0, tgt, outer)[:n_buckets]
    cnt = x.new_zeros(n_buckets + 1).index_add_(0, tgt, matched)[:n_buckets]
    nm = cnt[:, None].expand(n_buckets, 128).contiguous()
    return out, s40.reshape(n_buckets * 40, 40), nm


def _select_plain_fleet(par, piw_t, bcov_t, vc_t, plane_t, flags_t, mask_t, bidx_t,
                        levels: int, n_buckets: int):
    """``select_plain`` of a fleet (par [B, 8]): each replica's rows with
    their buckets counted from the replica's first, a bucket of another
    replica read as none; the outputs side by side."""
    batch = par.shape[0]
    rpr, nbr = piw_t.shape[1] // batch, n_buckets // batch
    outs = []
    for r in range(batch):
        cols = slice(r * rpr, (r + 1) * rpr)
        b = bidx_t[:, cols].to(torch.int64) - r * nbr
        local = torch.where((b >= 0) & (b < nbr), b, nbr).to(bidx_t.dtype)
        outs.append(select_plain(par[r], piw_t[:, cols], bcov_t[:, cols], vc_t[:, cols],
                                 plane_t[:, cols], flags_t[:, cols], mask_t[:, cols], local,
                                 levels, nbr))
    out, s40, nm = zip(*outs)
    return torch.cat(out, dim=1), torch.cat(s40), torch.cat(nm)


def select_call(par, piw_t, bcov_t, vc_t, plane_t, flags_t, mask_t, bidx_t,
                levels: int, n_buckets: int):
    """The select kernel on a CUDA tensor (one launch), the plain version on
    a CPU one; par [8], or [B, 8] for a fleet of B replicas of C / B rows
    and n_buckets / B buckets each."""
    if par.device.type != "cuda":
        return select_plain(par, piw_t, bcov_t, vc_t, plane_t, flags_t, mask_t, bidx_t,
                            levels, n_buckets)
    C = piw_t.shape[1]
    batch = par.shape[0] if par.dim() == 2 else 1
    args = (par.reshape(-1), piw_t, bcov_t, vc_t, plane_t, flags_t, mask_t, bidx_t)
    rows = (None, 6, 18, 6 * levels, 62 * levels, 4 * levels, 1, 1)
    for a, nr in zip(args[1:], rows[1:]):
        if tuple(a.shape) != (nr, C):
            raise ValueError(f"select_call: shape {tuple(a.shape)}, expected {(nr, C)}")
    if args[0].numel() != 8 * batch or C % batch or n_buckets % batch or not 1 <= levels <= 4:
        raise ValueError("select_call: par must hold 8 floats a replica, the rows and buckets "
                         "split evenly over the replicas and 1 <= levels <= 4")
    dev = _build.check_tensors("select_call", args, [F32] * 8)
    outs = (
        torch.empty((46, C), dtype=F32, device=dev),
        torch.empty((n_buckets * 40, 40), dtype=F32, device=dev),
        torch.empty((n_buckets, 128), dtype=F32, device=dev),
    )
    _build.launch("select_launch", args + outs, [C, levels, n_buckets, batch])
    select_call.launches += 1
    return outs


select_call.launches = 0
