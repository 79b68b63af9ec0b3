"""Insert-phase moment rows: CUDA kernel + plain version.

Replaces the JAX package's Pallas kernel ``_moments_kernel``
(ops/pallas/insert_rows.py:46, driven by ``moments_call`` :148).  Two
entries, one kernel (``csrc/insert_rows.cu``):

* ``moments_rows_call`` -- the insert phase's.  It reads every input by
  index from the tensors the match phase and the chain leave, so nothing is
  gathered, concatenated or transposed in front of it:

      ext_r [3,3] (the run's own tensor), sizes [L] f32 voxel size by level
      (``level_sizes``, built once a configuration), the chain's per-bucket
      rots [NB,3,3], poss [NB,3], rot_covs, pos_covs [NB,3,3], the match
      phase's p_i_c [N,3] and body_cov_c [N,3,3] (any strides: the keys
      kernel leaves them in [component, row] layout), and the gated rows'
      pidx [R] (a row's point), bidx [N] (a point's bucket, clamped to
      NB - 1 in the kernel), keys [R,3] int32 (exact as f32 for
      |k| < 2^24) and lvl [R] (any stride)
      -> (mom [R,9] m1(3) m2(6), moms [R,60] s0(6) s1(18) s2(36)), row-major
      for the two ``index_add_`` calls that take them.

* ``moments_call`` -- the JAX kernel's row contract:

      par [16] (ext_r row-major in 0:9), prow [12,R] (p_i, LiDAR-frame sensor
      cov), brow [30,R] (bucket rot 9, pos 3, rot-block cov 9, pos-block cov 9),
      key [3,R] (voxel key as f32), size [1,R]
      -> [69,R] packed moments m1(3) m2(6) | s0(6) s1(18) s2(36)

  On the card it runs the same kernel with every row its own bucket and its
  own size (identity indices).

On a CUDA tensor each entry launches the kernel; on a CPU tensor it runs its
plain version (``moments_rows_plain`` is the gather in torch, then
``moments_plain``).

A fleet of B replicas calls ``moments_rows_call`` once with ext_r [B,3,3]
and the replicas' buckets, points and rows side by side (replica r's
buckets r * NB/B ..., points r * N/B ..., rows r * R/B ...), every index
global and each point's bucket one of its replica's: one launch, each row
reading its bucket's replica's extrinsic rotation.  The plain version runs
the replicas one after another.
"""

from __future__ import annotations

import functools

import torch

from . import _build
from .match_geom import _sandwich

F32 = torch.float32
I32 = torch.int32
I64 = torch.int64
PAR_W = 16
_SYM6_PAIRS = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


@functools.lru_cache(maxsize=None)
def level_sizes(voxel_size: float, levels: int, device) -> torch.Tensor:
    """[levels] f32 voxel size by level, rounded from the double
    voxel_size / 2^l; one tensor a configuration and device (read only)."""
    return torch.tensor([voxel_size / (2.0 ** l) for l in range(levels)], dtype=F32, device=device)


def moments_plain(par, prow_t, brow_t, key_t, size_t):
    """Plain PyTorch version of the moments kernel (JAX row contract)."""
    e = par.reshape(-1)
    pi = [prow_t[i] for i in range(3)]
    r = [brow_t[i] for i in range(9)]
    pw = [r[3 * i] * pi[0] + r[3 * i + 1] * pi[1] + r[3 * i + 2] * pi[2] + brow_t[9 + i]
          for i in range(3)]
    re = [r[3 * i] * e[j] + r[3 * i + 1] * e[3 + j] + r[3 * i + 2] * e[6 + j]
          for i in range(3) for j in range(3)]
    zero = torch.zeros_like(pi[0])
    sk = [zero, -pi[2], pi[1], pi[2], zero, -pi[0], -pi[1], pi[0], zero]
    rc = [r[3 * i] * sk[j] + r[3 * i + 1] * sk[3 + j] + r[3 * i + 2] * sk[6 + j]
          for i in range(3) for j in range(3)]
    bc = [[prow_t[3 + 3 * i + j] for j in range(3)] for i in range(3)]
    crr = [[brow_t[12 + 3 * i + j] for j in range(3)] for i in range(3)]
    w1 = _sandwich(re, bc)
    w2 = _sandwich(rc, crr)
    var = [w1[k] + w2[k] + brow_t[21 + k] for k in range(9)]
    size = size_t[0]
    prel = [pw[i] - (key_t[i] + 0.5) * size for i in range(3)]
    m2 = [prel[i] * prel[j] for (i, j) in _SYM6_PAIRS]
    v6 = [var[3 * i + j] for (i, j) in _SYM6_PAIRS]
    rows = prel + m2 + v6
    rows += [v * prel[a] for v in v6 for a in range(3)]
    rows += [v * q for v in v6 for q in m2]
    return torch.stack(rows)


def moments_rows_plain(ext_r, sizes, rots, poss, rot_covs, pos_covs, p_i_c, body_cov_c,
                       pidx, bidx, keys, lvl):
    """Plain version of ``moments_rows_call``: the rows gathered in torch,
    then ``moments_plain``; returns (mom [R,9], moms [R,60])."""
    if ext_r.dim() == 3:  # a fleet: the replicas one after another, indices made local
        batch = ext_r.shape[0]
        nbr, n, rr = rots.shape[0] // batch, p_i_c.shape[0] // batch, pidx.shape[0] // batch
        outs = []
        for r in range(batch):
            bk, pt, rw = (slice(r * k, (r + 1) * k) for k in (nbr, n, rr))
            outs.append(moments_rows_plain(
                ext_r[r], sizes, rots[bk], poss[bk], rot_covs[bk], pos_covs[bk], p_i_c[pt],
                body_cov_c[pt], pidx[rw] - r * n, bidx[pt] - r * nbr, keys[rw], lvl[rw]))
        return tuple(torch.cat(xs) for xs in zip(*outs))
    nb = rots.shape[0]
    bucket_rows = torch.cat(
        [rots.reshape(nb, 9), poss, rot_covs.reshape(nb, 9), pos_covs.reshape(nb, 9)], dim=1
    )
    brow_t = bucket_rows[torch.clamp(bidx, max=nb - 1)[pidx]].T
    prow_t = torch.cat([p_i_c, body_cov_c.reshape(-1, 9)], dim=1)[pidx].T
    out = moments_plain(ext_r.reshape(9), prow_t, brow_t, keys.T.to(p_i_c.dtype), sizes[lvl][None, :])
    return out[0:9].T, out[9:69].T


def moments_rows_call(ext_r, sizes, rots, poss, rot_covs, pos_covs, p_i_c, body_cov_c,
                      pidx, bidx, keys, lvl):
    """The moments kernel on a CUDA tensor, ``moments_rows_plain`` on a CPU one.
    A row's ``pidx`` must name a point, its ``lvl`` a size and its point's
    ``bidx`` be >= 0: the kernel traps on one that does not, as indexing a
    CUDA tensor asserts.  ext_r [B,3,3] makes it a fleet's call (module
    doc)."""
    if rots.device.type != "cuda":
        return moments_rows_plain(ext_r, sizes, rots, poss, rot_covs, pos_covs, p_i_c, body_cov_c,
                                  pidx, bidx, keys, lvl)
    name = "moments_rows_call"
    nb, n, r = rots.shape[0], p_i_c.shape[0], pidx.shape[0]
    batch = ext_r.shape[0] if ext_r.dim() == 3 else 1
    want = {"rots": (rots, (nb, 3, 3)), "poss": (poss, (nb, 3)), "rot_covs": (rot_covs, (nb, 3, 3)),
            "pos_covs": (pos_covs, (nb, 3, 3)), "p_i_c": (p_i_c, (n, 3)),
            "body_cov_c": (body_cov_c, (n, 3, 3)), "bidx": (bidx, (n,)), "keys": (keys, (r, 3)),
            "lvl": (lvl, (r,))}
    for key, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, expected {shape}")
    if nb < 1:
        raise ValueError(f"{name}: no buckets")
    if ext_r.numel() != 9 * batch or nb % batch or sizes.dim() != 1:
        raise ValueError(f"{name}: ext_r must hold 9 floats a replica, the buckets split evenly "
                         "over the replicas and sizes be 1-D")
    if body_cov_c.stride(1) != 3 * body_cov_c.stride(2):
        raise ValueError(f"{name}: body_cov_c's rows must read as 9 floats at one stride")
    args = (ext_r, sizes, rots, poss, rot_covs, pos_covs, p_i_c, body_cov_c, pidx, bidx, keys, lvl)
    dev = _build.check_tensors(name, args, [F32] * 8 + [I64, I64, I32, I64], strided=(6, 7, 10, 11))
    mom = torch.empty((r, 9), dtype=F32, device=dev)
    moms = torch.empty((r, 60), dtype=F32, device=dev)
    _build.launch(
        "moments_rows_launch", args + (mom, moms),
        [r, nb, n, sizes.shape[0], *p_i_c.stride(), body_cov_c.stride(0), body_cov_c.stride(2),
         *keys.stride(), lvl.stride(0), batch],
    )
    moments_rows_call.launches += 1
    return mom, moms


def moments_call(par, prow_t, brow_t, key_t, size_t):
    """The moments kernel on a CUDA tensor (through ``moments_rows_call``,
    a row its own bucket), its plain version on a CPU one."""
    if par.device.type != "cuda":
        return moments_plain(par, prow_t, brow_t, key_t, size_t)
    R = prow_t.shape[1]
    args = (par.reshape(-1), prow_t, brow_t, key_t, size_t)
    for a, nr in zip(args[1:], (12, 30, 3, 1)):
        if tuple(a.shape) != (nr, R):
            raise ValueError(f"moments_call: shape {tuple(a.shape)}, expected {(nr, R)}")
    if args[0].numel() != PAR_W:
        raise ValueError(f"moments_call: par must hold {PAR_W} floats")
    _build.check_tensors("moments_call", args, [F32] * 5)
    mom, moms = moments_rows_call(*rows_of_jax_layout(*args))
    moments_call.launches += 1
    return torch.cat([mom, moms], dim=1).T


def rows_of_jax_layout(par, prow_t, brow_t, key_t, size_t):
    """``moments_rows_call``'s arguments for the JAX row contract: row r is
    its own point and its own bucket (identity indices), at its own size."""
    R = prow_t.shape[1]
    idx = torch.arange(R, dtype=I64, device=prow_t.device)

    def table(lo, hi):
        return brow_t[lo:hi].T.contiguous()

    return (par.reshape(-1)[0:9], size_t[0], table(0, 9).reshape(R, 3, 3), table(9, 12),
            table(12, 21).reshape(R, 3, 3), table(21, 30).reshape(R, 3, 3), prow_t[0:3].T,
            prow_t[3:12].T.reshape(R, 3, 3), idx, idx, key_t.to(I32).T, idx)


moments_rows_call.launches = 0
moments_call.launches = 0
