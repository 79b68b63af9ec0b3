"""The moments and refit kernels' indexed entries on the CPU.

``moments_rows_call`` and ``fit_slots_call`` read their rows by index from
the tensors the path already holds (the chain's per-bucket outputs, the
match phase's per-point rows, the map's tables).  On CPU tensors they run
their plain versions, which these tests hold against the JAX package's
kernels in interpret mode (fed by the JAX package's own gathers), and the
insert through them against the explicit gather-and-plain route the insert
took before: every map table ``torch.equal``, slot for slot.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from legkilo_tpu.core import voxel_map as jv
from legkilo_tpu.ops.pallas import insert_rows as j_ir
from legkilo_tpu.ops.pallas import plane_fit_rows as j_pfr

from legkilo_torch.core import filter_deferred as t_fd
from legkilo_torch.core import voxel_map as tv
from legkilo_torch.core.filter import FilterParams
from legkilo_torch.ops import insert_rows as t_ir
from legkilo_torch.ops import plane_fit_rows as t_pfr
from torch_util import N, T, cloned, one_thread  # noqa: F401

VOXEL = 0.5
LEVELS = 3
THRESHOLD = 0.01
STORAGE = ["f32", "f16", "bf16"]


def rotations(rng, n, scale):
    from scipy.spatial.transform import Rotation

    return Rotation.from_rotvec(rng.normal(scale=scale, size=(n, 3))).as_matrix().astype(np.float32)


def psd(rng, n, scale):
    a = rng.normal(size=(n, 3, 3)) * scale
    return (a @ np.swapaxes(a, 1, 2)).astype(np.float32)


def scene(rng, n):
    """Points on three planes plus scatter, with world covariances."""
    pts = []
    for axis, off in ((2, 0.1), (0, 1.3), (1, -1.2)):
        uv = rng.uniform(-1, 1, size=(n // 4, 3))
        uv[:, axis] = off + rng.normal(scale=0.003, size=n // 4)
        pts.append(uv)
    pts.append(rng.uniform(-2, 2, size=(n - 3 * (n // 4), 3)))
    p = np.concatenate(pts)[rng.permutation(n)].astype(np.float32)
    return p, psd(rng, n, 0.01) + np.float32(1e-6) * np.eye(3, dtype=np.float32), rng.random(n) < 0.9


def bucket_outputs(rng, nb):
    """The chain's per-bucket outputs: rots [NB,3,3], poss [NB,3], rot_covs,
    pos_covs [NB,3,3]."""
    return (rotations(rng, nb, 0.2), rng.normal(scale=0.5, size=(nb, 3)).astype(np.float32),
            psd(rng, nb, 1e-3), psd(rng, nb, 1e-3))


def as_match_layout(p_i, body_cov):
    """p_i_c [N,3] and body_cov_c [N,3,3] as the keys kernel leaves them:
    views of [component, point] tensors."""
    n = p_i.shape[0]
    piw_t = torch.zeros((6, n))
    piw_t[0:3] = T(p_i).T
    covs_t = torch.zeros((27, n))
    covs_t[18:27] = T(body_cov.reshape(n, 9)).T
    return piw_t[0:3].T, covs_t[18:27].T.reshape(n, 3, 3)


@pytest.mark.parametrize("nb", [28, 56])
def test_moments_rows_plain_matches_jax_gather_and_kernel(rng, nb):
    """The indexed entry against insert_phase_pallas's gathers and the JAX
    kernel, with points in no bucket (bidx NB and past it: the clamp), the
    point rows strided as the keys kernel leaves them and lvl a column view
    as gated_insert_rows leaves it."""
    n, r = 500, 384
    ext_r = rotations(rng, 1, 0.3)[0]
    rots, poss, rot_covs, pos_covs = bucket_outputs(rng, nb)
    # Data at the scale of test_moments_plain_matches_jax_kernel: m1 is a
    # difference of f32 values, exact to the ulp of |p_w|, and XLA fuses
    # the pose products where torch does not.
    p_i = rng.normal(size=(n, 3)).astype(np.float32)
    body_cov = psd(rng, n, 0.1)
    bidx = np.minimum(np.arange(n) * nb // (n - 40), nb).astype(np.int64)
    bidx[-5:] = nb + 3
    pidx = rng.integers(0, n, size=r).astype(np.int64)
    lvl = rng.integers(0, LEVELS, size=r).astype(np.int64)
    keys = rng.integers(-20, 20, size=(r, 3)).astype(np.int32)
    sizes = np.asarray([VOXEL / 2.0 ** l for l in range(LEVELS)], np.float32)

    # The JAX package's insert_phase_pallas, gather for gather.
    bidx_r = jnp.take(jnp.minimum(jnp.asarray(bidx), nb - 1), jnp.asarray(pidx))
    par = jnp.concatenate([jnp.asarray(ext_r).reshape(9), jnp.zeros((7,), jnp.float32)])[None, :]
    bucket_rows = jnp.concatenate([jnp.asarray(rots).reshape(nb, 9), jnp.asarray(poss),
                                   jnp.asarray(rot_covs).reshape(nb, 9),
                                   jnp.asarray(pos_covs).reshape(nb, 9)], axis=1)
    prow_t = jnp.take(jnp.concatenate([jnp.asarray(p_i), jnp.asarray(body_cov).reshape(-1, 9)], axis=1),
                      jnp.asarray(pidx), axis=0).T
    j = np.asarray(j_ir.moments_call(par, prow_t, jnp.take(bucket_rows, bidx_r, axis=0).T,
                                     jnp.asarray(keys).T.astype(jnp.float32),
                                     jnp.asarray(sizes)[jnp.asarray(lvl)][None, :],
                                     interpret=True, block=128))

    p_i_c, body_cov_c = as_match_layout(p_i, body_cov)
    rows7 = torch.zeros((r, 7), dtype=torch.int64)
    rows7[:, 3] = T(lvl)
    n0 = t_ir.moments_rows_call.launches
    mom, moms = t_ir.moments_rows_call(
        T(ext_r), t_ir.level_sizes(VOXEL, LEVELS, torch.device("cpu")),
        *(T(x) for x in (rots, poss, rot_covs, pos_covs)), p_i_c, body_cov_c,
        T(pidx), T(bidx), T(keys), rows7[:, 3])
    assert t_ir.moments_rows_call.launches == n0   # a CPU tensor launches nothing
    assert mom.shape == (r, 9) and moms.shape == (r, 60)
    # The tolerances of test_moments_plain_matches_jax_kernel.
    np.testing.assert_allclose(N(mom), j[0:9].T, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(N(moms), j[9:69].T, rtol=1e-4, atol=1e-7)


def _map_tables(rng, storage):
    """A JAX map after one insert of a scene: its meta/mom/moms tables with
    the zero sentinel row appended (moms in the storage dtype), and a refit
    row list of 128 slots, the occupied ones first, then the sentinel."""
    jc = jv.MapConfig(levels=LEVELS, capacity=256, probe=4, voxel_size=VOXEL,
                      planer_threshold=THRESHOLD, sigma_num=3.0, max_points_num=50,
                      init_num=(5, 5, 5), insert_rounds=2, refit_budget=256)
    p, var, mask = scene(rng, 700)
    vm = jv.insert_points(jv.make_map(jc), jc, *(jnp.asarray(x) for x in (p, var, mask)))
    miss = LEVELS * jc.capacity
    meta_x, mom_x, moms_x = (tv._with_sentinel(T(np.asarray(x))) for x in (vm.meta, vm.mom, vm.moms))
    moms_x = moms_x.to(tv._STORAGE[storage])
    occ = np.nonzero(np.asarray(vm.meta)[:, 0] > 0)[0]
    fs = np.full(128, miss, np.int64)
    take = rng.permutation(occ)[:96]
    fs[: len(take)] = take
    return meta_x, mom_x, moms_x, T(fs)


@pytest.mark.parametrize("storage", STORAGE)
def test_fit_slots_plain_matches_jax_kernel(rng, storage):
    """The indexed refit against the JAX kernel on the same rows, gathered
    by ``fs`` with its sentinel entries; moms in each storage dtype (the
    JAX side gets them converted to f32, which is exact)."""
    meta_x, mom_x, moms_x, fs = _map_tables(rng, storage)
    par = np.zeros(8, np.float32)
    par[0] = THRESHOLD
    mom_t = np.concatenate([N(mom_x[fs]), N(moms_x[fs].float())], axis=1).T
    j_out = np.asarray(j_pfr.fit_rows_call(jnp.asarray(par)[None, :], jnp.asarray(mom_t),
                                           jnp.asarray(N(meta_x[fs]).T), interpret=True, block=128)).T
    n0 = t_pfr.fit_slots_call.launches
    t_out = N(t_pfr.fit_slots_call(t_pfr.fit_par(THRESHOLD, torch.device("cpu")), meta_x, mom_x, moms_x, fs))
    assert t_pfr.fit_slots_call.launches == n0
    assert t_out.shape == (128, 35) and np.isfinite(t_out).all()
    sentinel = N(fs) == LEVELS * 256
    assert sentinel.sum() >= 32
    np.testing.assert_array_equal(t_out[sentinel, 31:35], [[0.0, 0.0, 1.0, 1.0]] * sentinel.sum())
    # test_fit_rows_plain_matches_jax_kernel_and_fit_planes's tolerances:
    # centre and evals to 1e-5 (5e-5: near-degenerate voxels), the meta row
    # exact; normals 2e-4 and plane_var 5e-4 of its scale where the fit is
    # well conditioned (lam_mid > 1e-3).
    np.testing.assert_allclose(t_out[:, 0:3], j_out[:, 0:3], atol=1e-5)
    np.testing.assert_allclose(t_out[:, 6:10], j_out[:, 6:10], atol=5e-5)
    np.testing.assert_array_equal(t_out[:, 31:35], j_out[:, 31:35])
    well = j_out[:, 7] > 1e-3
    assert well.sum() >= 10
    np.testing.assert_allclose(t_out[well, 3:6], j_out[well, 3:6], atol=2e-4)
    scale = np.maximum(1.0, np.abs(j_out[well, 10:31]).max(axis=1, keepdims=True))
    np.testing.assert_allclose(t_out[well, 10:31] / scale, j_out[well, 10:31] / scale, atol=5e-4)


def test_moments_jax_layout_is_the_rows_entry_on_identity_indices(rng):
    """``moments_call`` runs the kernel on the card through
    ``rows_of_jax_layout``: the same rows, bit for bit, on the plain side."""
    r = 200
    par = np.zeros(16, np.float32)
    par[0:9] = rotations(rng, 1, 0.3)[0].reshape(9)
    rb = rotations(rng, r, 0.2).reshape(r, 9)
    prow = np.concatenate([rng.normal(size=(r, 3)), psd(rng, r, 0.01).reshape(r, 9)], 1)
    brow = np.concatenate([rb, rng.normal(size=(r, 3)), psd(rng, r, 1e-3).reshape(r, 9),
                           psd(rng, r, 1e-3).reshape(r, 9)], 1)
    key = rng.integers(-20, 20, size=(3, r)).astype(np.float32)
    size = (VOXEL / 2.0 ** rng.integers(0, LEVELS, size=(1, r))).astype(np.float32)
    args = tuple(T(x.astype(np.float32)) for x in (par, prow.T, brow.T, key, size))
    mom, moms = t_ir.moments_rows_plain(*t_ir.rows_of_jax_layout(*args))
    want = t_ir.moments_call(*args)
    assert torch.equal(torch.cat([mom, moms], dim=1).T, want)


def test_fit_jax_layout_is_the_slots_entry_on_identity_indices(rng):
    """``fit_rows_call`` runs the kernel on the card through
    ``slots_of_jax_layout``: the same rows, bit for bit, on the plain side."""
    meta_x, mom_x, moms_x, fs = _map_tables(rng, "f32")
    mom_t = torch.cat([mom_x[fs], moms_x[fs]], dim=1).T.contiguous()
    meta_t = meta_x[fs].T.contiguous()
    par = t_pfr.fit_par(THRESHOLD, torch.device("cpu"))
    got = t_pfr.fit_slots_plain(par, *t_pfr.slots_of_jax_layout(mom_t, meta_t))
    assert torch.equal(got.T, t_pfr.fit_rows_call(par, mom_t, meta_t))


def _fit_gather_route(par, meta_x, mom_x, moms_x, fs):
    """The refit as _insert_finish ran it before the indexed entry: the
    slots' rows gathered, concatenated and transposed, a par built a call,
    the JAX-layout plain version; [B,35] as the call site reads it."""
    meta_r = meta_x[fs]
    mom_r = torch.cat([mom_x[fs], moms_x[fs].to(torch.float32)], dim=-1)
    par8 = torch.zeros(8)
    par8[0] = THRESHOLD
    return t_pfr.fit_rows_plain(par8, mom_r.T.contiguous(), meta_r.T.contiguous()).T


def _moments_gather_route(vm, mcfg, params, bidx, p_i_c, body_cov_c, mask_c, own_keys, own_slot,
                          own_found, own_plane, rots, poss, rot_covs, pos_covs):
    """insert_phase as it ran before the indexed entry: the per-row gathers
    of the bucket and point rows, their transposes, a par and the sizes
    built a call, the JAX-layout plain version."""
    nb = rots.shape[0]
    rows = tv.gated_insert_rows(mcfg, mask_c, own_keys, own_slot, own_found, own_plane)
    bidx_r = torch.clamp(bidx, max=nb - 1)[rows.pidx]
    sizes = torch.tensor([mcfg.voxel_size / (2.0 ** l) for l in range(mcfg.levels)])
    par = torch.cat([params.ext_r.reshape(9), torch.zeros(7)])
    bucket_rows = torch.cat([rots.reshape(nb, 9), poss, rot_covs.reshape(nb, 9), pos_covs.reshape(nb, 9)], 1)
    brow_t = bucket_rows[bidx_r].T.contiguous()
    prow_t = torch.cat([p_i_c, body_cov_c.reshape(-1, 9)], dim=1)[rows.pidx].T.contiguous()
    out69 = t_ir.moments_plain(par, prow_t, brow_t, rows.keys.T.to(torch.float32).contiguous(),
                               sizes[rows.lvl][None, :])
    return tv.insert_packed_rows_hinted(vm, mcfg, rows, out69[0:9].T, out69[9:69].T)


def _port_cfg(storage):
    return tv.MapConfig(levels=LEVELS, capacity=256, probe=4, voxel_size=VOXEL, planer_threshold=THRESHOLD,
                        sigma_num=3.0, max_points_num=50, init_num=(5, 5, 5), insert_rounds=2,
                        refit_budget=128, insert_row_cap=512, use_pallas_refit=True, storage_dtype=storage)


def _assert_maps_equal(a, b):
    for f in tv.VoxelMap._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("storage", STORAGE)
def test_insert_phase_matches_the_gather_and_plain_route(rng, storage, monkeypatch):
    """insert_phase (moments rows by index, the indexed refit) against the
    route it replaced, over two inserts so refits of existing planes come in;
    the point rows strided as the keys kernel leaves them, points past the
    last bucket."""
    tc = _port_cfg(storage)
    p, var, mask = scene(rng, 1200)
    vm = tv.insert_points(tv.make_map(tc, "cpu"), tc, *(T(x) for x in (p[:400], var[:400], mask[:400])))
    nb = 8
    rots, poss, rot_covs, pos_covs = bucket_outputs(rng, nb)
    ext_r = rotations(rng, 1, 0.3)[0]
    params = FilterParams(noise=None, ext_r=T(ext_r), ext_t=torch.zeros(3), g_over_acc_norm=torch.tensor(1.0))
    new, ref = vm, cloned(vm)
    for lo in (400, 800):
        q, qv, qm = p[lo:lo + 400], var[lo:lo + 400], mask[lo:lo + 400]
        bidx = np.minimum(np.arange(400) * nb // 380, nb).astype(np.int64)
        b = np.minimum(bidx, nb - 1)
        # Body-frame points whose post-update world position is q.
        p_i = np.einsum("nji,nj->ni", rots[b], q - poss[b]).astype(np.float32)
        p_i_c, body_cov_c = as_match_layout(p_i, qv)
        tail = (T(bidx), p_i_c, body_cov_c, T(qm))
        chain = tuple(T(x) for x in (rots, poss, rot_covs, pos_covs))

        def own(m):
            return m.own_keys, m.own_slot, m.own_found, m.own_plane

        n0 = (t_ir.moments_rows_call.launches, t_pfr.fit_slots_call.launches)
        new = t_fd.insert_phase(new, tc, params, *tail,
                                *own(tv.match_points(new, tc, T(q), T(qv), T(qm))), *chain)
        assert (t_ir.moments_rows_call.launches, t_pfr.fit_slots_call.launches) == n0
        with monkeypatch.context() as mp:
            mp.setattr(tv, "fit_slots_call", _fit_gather_route)
            ref = _moments_gather_route(ref, tc, params, *tail,
                                        *own(tv.match_points(ref, tc, T(q), T(qv), T(qm))), *chain)
        _assert_maps_equal(new, ref)
    assert N(new.meta)[:, 3].sum() > 10


@pytest.mark.parametrize("storage", STORAGE)
def test_insert_points_refit_matches_the_gather_and_plain_route(rng, storage, monkeypatch):
    """_insert_finish on the per-point path's insert (and the first-frame
    map) through the indexed refit, against the gather-and-plain refit."""
    tc = _port_cfg(storage)
    p, var, mask = scene(rng, 900)
    new = ref = tv.make_map(tc, "cpu")
    for lo in (0, 300, 600):
        chunk = tuple(T(x) for x in (p[lo:lo + 300], var[lo:lo + 300], mask[lo:lo + 300]))
        new = tv.insert_points(new, tc, *chunk)
        with monkeypatch.context() as mp:
            mp.setattr(tv, "fit_slots_call", _fit_gather_route)
            ref = tv.insert_points(ref, tc, *chunk)
        _assert_maps_equal(new, ref)
    assert N(new.meta)[:, 3].sum() > 10
