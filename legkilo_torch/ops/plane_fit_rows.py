"""Voxel-map plane refit rows: CUDA kernel + plain version.

Replaces the JAX package's Pallas kernel ``_fit_kernel``
(ops/pallas/plane_fit_rows.py:122, driven by ``fit_rows_call`` :295) with
its row contract (B = refit budget):

    par [8] (planer_threshold at 0), mom_t [69,B] packed moments
    (voxel_map._pack_moments: m1 @0, m2 sym6 @3, s0 sym6 @9, s1 @15,
    s2 @33), meta_t [4,B] (n, new_n, initialized, is_plane)
    -> [35,B]: the plane row (centre_rel 3, normal 3, evals 3, radius 1,
    plane_var upper triangle 21) then the meta row (n, 0, 1, is_plane) --
    the rows voxel_map._insert_finish scatters.

On a CUDA tensor ``fit_rows_call`` launches ``csrc/plane_fit_rows.cu`` (one
thread per slot); on a CPU tensor it runs ``fit_rows_plain``, which is the
kernel's arithmetic in the kernel's order of operations on [B] rows, so the
two take the same branches.  Unlike core/plane_fit.fit_planes it multiplies
by 1/p instead of dividing, and masks plane_var by multiplying with is_plane.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .eig3x3 import acos_poly

F32 = torch.float32
PAR_W = 8
_EPS = 1e-12        # ops/eig3x3._EPS
_ALPHA_EPS = 1e-7   # core/plane_fit._ALPHA_EPS
# Divisions by a constant are written as products with its reciprocal, in
# the kernel too: PyTorch divides a CUDA tensor by a Python scalar that way
# and a CPU tensor truly, and the two round differently.
_THIRD = 1.0 / 3.0
_SIXTH = 1.0 / 6.0
_SYM6 = {(0, 0): 0, (0, 1): 1, (0, 2): 2, (1, 1): 3, (1, 2): 4, (2, 2): 5}


def _sym6(i: int, j: int) -> int:
    return _SYM6[(min(i, j), max(i, j))]


def _cross(a, b):
    return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0]]


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _sqrt0(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def _const(like, value):
    return torch.full_like(like, value)


def _any_orthogonal(v):
    use_x = torch.abs(v[0]) < 0.9
    base = [torch.where(use_x, 1.0, 0.0).to(v[0].dtype), torch.where(use_x, 0.0, 1.0).to(v[0].dtype),
            torch.zeros_like(v[0])]
    w = _cross(v, base)
    inv = 1.0 / torch.clamp(_sqrt0(_dot(w, w)), min=_EPS)
    return [w[i] * inv for i in range(3)]


def _pick(rows, norms):
    """rows[argmax(norms)] per slot, the first maximum winning."""
    p0 = (norms[0] >= norms[1]) & (norms[0] >= norms[2])
    p1 = ~p0 & (norms[1] >= norms[2])
    return [torch.where(p0, rows[0][i], torch.where(p1, rows[1][i], rows[2][i])) for i in range(3)]


def _eigvec(cov, lam):
    m = [[cov[i][j] - lam if i == j else cov[i][j] for j in range(3)] for i in range(3)]
    cands = [_cross(m[0], m[1]), _cross(m[0], m[2]), _cross(m[1], m[2])]
    v = _pick(cands, [_dot(c, c) for c in cands])
    nrm2 = _dot(v, v)
    nrm = _sqrt0(nrm2)
    rn = [_dot(r, r) for r in m]
    rbest = _pick(m, rn)
    rbest_n = _sqrt0(_dot(rbest, rbest))
    inv_rb = 1.0 / torch.clamp(rbest_n, min=_EPS)
    plane_fb = _any_orthogonal([rbest[i] * inv_rb for i in range(3)])
    has_row = rbest_n > _EPS
    fallback = [torch.where(has_row, plane_fb[i], _const(rbest_n, 1.0 if i == 0 else 0.0))
                for i in range(3)]
    scale = torch.clamp(torch.maximum(rn[0], torch.maximum(rn[1], rn[2])), min=_EPS)
    good = (nrm2 > 1e-12 * scale * scale) & (nrm > _EPS)
    inv_n = 1.0 / torch.clamp(nrm, min=_EPS)
    return [torch.where(good, v[i] * inv_n, fallback[i]) for i in range(3)]


def fit_rows_plain(par, mom_t, meta_t):
    """Plain PyTorch version of the refit kernel (same contract)."""
    threshold = par.reshape(-1)[0]

    def mr(i):
        return mom_t[i]

    def s1v(b, c, d):
        return mr(15 + _sym6(b, c) * 3 + d)

    def s2v(b, c, d, a):
        return mr(33 + _sym6(b, c) * 6 + _sym6(d, a))

    n = torch.clamp(meta_t[0], min=1.0)
    inv_n = 1.0 / n
    cr = [mr(i) * inv_n for i in range(3)]
    s0 = [[mr(9 + _sym6(i, j)) for j in range(3)] for i in range(3)]
    cov = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(i, 3):
            cov[i][j] = cov[j][i] = mr(3 + _sym6(i, j)) * inv_n - cr[i] * cr[j]

    # Eigenvalues: trigonometric closed form, acos by the shared polynomial.
    p1s = cov[0][1] * cov[0][1] + cov[0][2] * cov[0][2] + cov[1][2] * cov[1][2]
    q = (cov[0][0] + cov[1][1] + cov[2][2]) * _THIRD
    dq = [cov[i][i] - q for i in range(3)]
    p2 = dq[0] * dq[0] + dq[1] * dq[1] + dq[2] * dq[2] + 2.0 * p1s
    p = _sqrt0(p2 * _SIXTH)
    diagonal = p1s < _EPS
    inv_p = 1.0 / torch.where(p > _EPS, p, torch.ones_like(p))
    b = [[(dq[i] if i == j else cov[i][j]) * inv_p for j in range(3)] for i in range(3)]
    detb = (
        b[0][0] * (b[1][1] * b[2][2] - b[1][2] * b[2][1])
        - b[0][1] * (b[1][0] * b[2][2] - b[1][2] * b[2][0])
        + b[0][2] * (b[1][0] * b[2][1] - b[1][1] * b[2][0])
    )
    phi = acos_poly(torch.clamp(detb * 0.5, -1.0, 1.0)) * _THIRD
    e_max_t = q + 2.0 * p * torch.cos(phi)
    e_min_t = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid_t = 3.0 * q - e_max_t - e_min_t
    d0, d1, d2 = cov[0][0], cov[1][1], cov[2][2]
    dmin = torch.minimum(torch.minimum(d0, d1), d2)
    dmax = torch.maximum(torch.maximum(d0, d1), d2)
    dmid = d0 + d1 + d2 - dmin - dmax
    lam_min = torch.where(diagonal, dmin, e_min_t)
    lam_mid = torch.where(diagonal, dmid, e_mid_t)
    lam_max = torch.where(diagonal, dmax, e_max_t)

    v_min = _eigvec(cov, lam_min)
    v_max = _eigvec(cov, lam_max)
    dot = _dot(v_min, v_max)
    v_max = [v_max[i] - dot * v_min[i] for i in range(3)]
    nrm = _sqrt0(_dot(v_max, v_max))
    fb = _any_orthogonal(v_min)
    inv = 1.0 / torch.clamp(nrm, min=_EPS)
    ok = nrm > 1e-4
    v_max = [torch.where(ok, v_max[i] * inv, fb[i]) for i in range(3)]
    v_mid = _cross(v_max, v_min)
    is_plane_f = (lam_min < threshold).to(mom_t.dtype)

    # plane_var: the fit_planes contraction, scalar-unrolled.
    e12 = [v_mid, v_max]
    alphas, bs = [], []
    for e_m, lam in zip(e12, (lam_mid, lam_max)):
        denom = n * (lam_min - lam)
        denom = torch.where(torch.abs(denom) < _ALPHA_EPS, _const(denom, -_ALPHA_EPS), denom)
        alphas.append(1.0 / denom)
        bs.append([[e_m[i] * v_min[j] + v_min[i] * e_m[j] for j in range(3)] for i in range(3)])

    # t[b,c,d,a] = s2[b,c,d,a] - s1[b,c,d] cr[a] - s1[b,c,a] cr[d] + s0[b,c] cr[d] cr[a],
    # symmetric in (b, c): 54 distinct values.
    t = {}
    for bi in range(3):
        for ci in range(bi, 3):
            for di in range(3):
                for ai in range(3):
                    t[(_sym6(bi, ci), di, ai)] = (
                        s2v(bi, ci, di, ai) - s1v(bi, ci, di) * cr[ai] - s1v(bi, ci, ai) * cr[di]
                        + s0[bi][ci] * cr[di] * cr[ai]
                    )

    def total(terms):
        acc = terms[0]
        for x in terms[1:]:
            acc = acc + x
        return acc

    # w_j[b,a] = sum_{c,d} b_j[c,d] t[b,c,d,a];  c_ij = sum_{a,b} b_i[a,b] w_j[b,a]
    c_mat = [[None, None], [None, None]]
    for j in range(2):
        w = [[total([bs[j][ci][di] * t[(_sym6(bi, ci), di, ai)]
                     for ci in range(3) for di in range(3)])
              for ai in range(3)] for bi in range(3)]
        for i in range(2):
            c_mat[i][j] = total([bs[i][ai][bi] * w[bi][ai] for ai in range(3) for bi in range(3)])

    # p1m[b,c,a] = s1[b,c,a] - s0[b,c] cr[a];  u_i[c] = sum_{a,b} b_i[a,b] p1m[b,c,a]
    us = [[total([bs[i][ai][bi] * (s1v(bi, ci, ai) - s0[bi][ci] * cr[ai])
                  for ai in range(3) for bi in range(3)])
           for ci in range(3)] for i in range(2)]

    t_nn = [[total([alphas[i] * alphas[j] * c_mat[i][j] * e12[i][r] * e12[j][s]
                    for i in range(2) for j in range(2)])
             for s in range(3)] for r in range(3)]
    t_nq = [[total([alphas[i] * inv_n * e12[i][r] * us[i][s] for i in range(2)])
             for s in range(3)] for r in range(3)]
    inv_n2 = inv_n * inv_n

    def pv(r, c):  # upper triangle of [[t_nn, t_nq], [t_nq^T, s0 / n^2]]
        if c < 3:
            return t_nn[r][c]
        if r < 3:
            return t_nq[r][c - 3]
        return s0[r - 3][c - 3] * inv_n2

    pv_rows = [pv(r, c) * is_plane_f for r in range(6) for c in range(r, 6)]
    meta_fit = [meta_t[0], torch.zeros_like(n), torch.ones_like(n), is_plane_f]
    return torch.stack(
        cr + v_min + [lam_min, lam_mid, lam_max, _sqrt0(lam_max)] + pv_rows + meta_fit
    )


def fit_rows_call(par, mom_t, meta_t):
    """The refit kernel on a CUDA tensor, its plain version on a CPU one."""
    if mom_t.device.type != "cuda":
        return fit_rows_plain(par, mom_t, meta_t)
    B = mom_t.shape[1]
    args = (par.reshape(-1), mom_t, meta_t)
    if tuple(mom_t.shape) != (69, B) or tuple(meta_t.shape) != (4, B):
        raise ValueError(f"fit_rows_call: shapes {tuple(mom_t.shape)}, {tuple(meta_t.shape)}, "
                         f"expected (69, B), (4, B)")
    if args[0].numel() != PAR_W:
        raise ValueError(f"fit_rows_call: par must hold {PAR_W} floats")
    dev = _build.check_tensors("fit_rows_call", args, [F32] * 3)
    out = torch.empty((35, B), dtype=F32, device=dev)
    _build.launch("fit_rows_launch", args + (out,), [B])
    fit_rows_call.launches += 1
    return out


fit_rows_call.launches = 0
