"""Each ported kernel's plain PyTorch version vs the JAX package's Pallas kernel.

The JAX side runs its ``*_call`` in interpret mode on the CPU, as the JAX
package's own tests do; the port's wrappers get CPU tensors and so run their
plain versions.  The same seeded numpy inputs feed both.  The CUDA kernels
themselves run only on the card (tests/test_torch_cuda.py, chip_smoke.py),
held against these plain versions there.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from legkilo_tpu.config import EskfConfig as JEskfConfig
from legkilo_tpu.core import eskf as j_eskf
from legkilo_tpu.core import eskf_fused as j_ef
from legkilo_tpu.core.filter import FilterParams as JParams, ScanPacket as JPacket, init_carry as j_init_carry
from legkilo_tpu.core.filter import StaticConfig as JStatic
from legkilo_tpu.core.voxel_map import MapConfig as JMapConfig
from legkilo_tpu.ops.pallas import chain_stats as j_cs
from legkilo_tpu.ops.pallas import insert_rows as j_ir
from legkilo_tpu.ops.pallas import match_geom as j_mg
from legkilo_tpu.ops.pallas import plane_fit_rows as j_pfr
from legkilo_tpu.ops.pallas import pose_prop as j_pp
from legkilo_tpu.core import filter_deferred as j_fd
from legkilo_tpu.core import plane_fit as j_pf
from legkilo_tpu.core import voxel_map as j_vm

from legkilo_torch import convert
from legkilo_torch.core.filter import ScanPacket
from legkilo_torch.ops import chain_stats as t_cs
from legkilo_torch.ops import insert_rows as t_ir
from legkilo_torch.ops import match_geom as t_mg
from legkilo_torch.ops import plane_fit_rows as t_pfr
from legkilo_torch.ops import pose_prop as t_pp
from legkilo_torch.core import filter_deferred as t_fd
from torch_util import N, T, one_thread  # noqa: F401


def rotations(rng, n, scale):
    from scipy.spatial.transform import Rotation

    return Rotation.from_rotvec(rng.normal(scale=scale, size=(n, 3))).as_matrix().astype(np.float32)


def _chain_setup(rng, use_kin, nb=8, p=32, k=2):
    """The inputs of tests/test_chain_stats.py: a perturbed covariance, IMU
    events in ~30% of the slots, floor matches for ~70% of the points."""
    a = rng.normal(size=(30, 30))
    cov = (a @ a.T * 1e-4 + 1e-5 * np.eye(30)).astype(np.float32)
    bt = ((np.arange(nb) + 1) * 0.002).astype(np.float32)
    acc = rng.normal(scale=0.05, size=(nb, k, 3)).astype(np.float32)
    acc[..., 2] += 9.81
    fields = dict(
        rebase=np.float32(0.0), end_offset=np.float32(nb * 0.002), bucket_time=bt,
        bucket_mask=np.ones(nb, bool),
        points=rng.uniform(1, 3, size=(nb, p, 3)).astype(np.float32),
        point_mask=rng.random((nb, p)) < 0.9,
        imu_time=(np.clip(bt[:, None] - 0.001, 0, None) * np.ones((1, k))).astype(np.float32),
        imu_mask=rng.random((nb, k)) < 0.3, imu_acc=acc,
        imu_gyr=rng.normal(scale=0.02, size=(nb, k, 3)).astype(np.float32),
        foot_pos=np.zeros((nb, k, 4, 3), np.float32), foot_vel=np.zeros((nb, k, 4, 3), np.float32),
        contact=np.zeros((nb, k, 4), bool),
    )
    if use_kin:
        fp = rng.normal(scale=0.2, size=(nb, k, 4, 3)).astype(np.float32)
        fp[..., 2] -= 0.3
        fields.update(foot_pos=fp,
                      foot_vel=rng.normal(scale=0.1, size=(nb, k, 4, 3)).astype(np.float32),
                      contact=rng.random((nb, k, 4)) < 0.6)
    normal = np.zeros((nb, p, 3), np.float32)
    normal[..., 2] = 1.0
    center = rng.uniform(-1, 1, size=(nb, p, 3)).astype(np.float32)
    center[..., 2] = 0.0
    matched = (rng.random((nb, p)) < 0.7) & fields["point_mask"]
    r_meas = rng.uniform(0.05, 0.3, size=(nb, p)).astype(np.float32)
    p_i = fields["points"] + np.asarray([0.0, 0.0, 0.2], np.float32)
    s40 = np.asarray(j_ef.point_suffstats(*(jnp.asarray(x) for x in (p_i, normal, center, r_meas, matched))))
    nmatch = matched.sum(-1).astype(np.int32)
    return cov, fields, s40, nmatch


@pytest.mark.parametrize("use_kin", [False, True], ids=["imu", "kin"])
def test_chain_plain_matches_jax_kernel(rng, use_kin):
    cov, fields, s40, nmatch = _chain_setup(rng, use_kin)
    mcfg = JMapConfig(levels=2, capacity=256, probe=4, voxel_size=0.5, planer_threshold=0.01,
                      sigma_num=3.0, max_points_num=50, init_num=(5, 5))
    jscfg = JStatic(map_cfg=mcfg, use_kin=use_kin, dept_err=0.04, beam_err=0.2)
    jparams = JParams(noise=j_eskf.make_noise_params(JEskfConfig()), ext_r=jnp.eye(3),
                      ext_t=jnp.asarray([0.0, 0.0, 0.2]), g_over_acc_norm=jnp.asarray(1.0))
    jcarry = j_init_carry(jscfg)._replace(cov=jnp.asarray(cov))
    jpkt = JPacket(**{k: jnp.asarray(v) for k, v in fields.items()})
    j_out = j_cs.run_chain_stats(jcarry, jpkt, jparams, jnp.asarray(s40), jnp.asarray(nmatch),
                                 use_kin=use_kin, interpret=True)

    import jax

    tcarry = convert.carry_from_numpy([np.asarray(x) for x in jax.tree.leaves(jcarry)], "cpu")
    tparams = convert.params_from_numpy([np.asarray(x) for x in jax.tree.leaves(jparams)], "cpu")
    tpkt = ScanPacket(**{k: T(v) for k, v in fields.items()})
    t_out = t_cs.run_chain_stats(tcarry, tpkt, tparams, T(s40), T(nmatch), use_kin=use_kin)

    # Same recursion, different association of the f32 products (the
    # kernel applies F P F^T as Q1 + (D Q1^T)^T): the tolerances of the JAX
    # package's own kernel-vs-plain test (tests/test_chain_stats.py), kin
    # looser for the 18x18 inverse.
    atol_pose, atol_cov = (1e-4, 5e-4) if use_kin else (3e-5, 2e-4)
    for a, b, tol in zip(t_out[1:5], j_out[1:5], (atol_pose, atol_pose, atol_cov, atol_cov)):
        np.testing.assert_allclose(N(a), np.asarray(b), atol=tol)
    np.testing.assert_array_equal(N(t_out[5]), np.asarray(j_out[5]))
    tc, jc = t_out[0], j_out[0]
    np.testing.assert_allclose(N(tc.state.lin), np.asarray(jc.state.lin), atol=1e-4)
    np.testing.assert_allclose(N(tc.state.rot), np.asarray(jc.state.rot), atol=atol_pose)
    np.testing.assert_allclose(N(tc.cov), np.asarray(jc.cov), atol=atol_cov)
    np.testing.assert_allclose(float(tc.last_predict_t), float(jc.last_predict_t), atol=1e-6)
    np.testing.assert_allclose(float(tc.last_update_t), float(jc.last_update_t), atol=1e-6)


def _keys_inputs(rng, c=256, levels=3):
    par = np.zeros((1, 64), np.float32)
    par[0, 0:9] = rotations(rng, 1, 0.05)[0].reshape(9)
    par[0, 9:12] = [0.0, 0.0, 0.2]
    par[0, 12:12 + levels] = [0.5 / 2 ** l for l in range(levels)]
    a = rng.normal(size=(3, 3)) * 1e-3
    par[0, 16:25] = (a @ a.T).reshape(9)
    par[0, 25:34] = (a.T @ a).reshape(9)
    par[0, 34:36] = [0.04, 0.2]
    pts = rng.uniform(-12, 12, size=(3, c)).astype(np.float32)  # negative keys included
    pts[2, :4] = 0.0                                              # the |z| < 1e-8 guard
    rb = rotations(rng, c, 0.3).reshape(c, 9).T.copy()
    pb = rng.normal(scale=2.0, size=(3, c)).astype(np.float32)
    return par, pts, rb, pb


def test_keys_plain_matches_jax_kernel(rng):
    par, pts, rb, pb = _keys_inputs(rng)
    levels, cap = 3, 1024
    j = j_mg.keys_call(*(jnp.asarray(x) for x in (par, pts, rb, pb)), levels=levels,
                       capacity=cap, interpret=True, block=128)
    t = t_mg.keys_call(*(T(x) for x in (par, pts, rb, pb)), levels, cap)
    # Keys, hash probe starts: exact (negative keys wrap through uint32).
    np.testing.assert_array_equal(N(t[2]), np.asarray(j[2]))
    np.testing.assert_array_equal(N(t[4]), np.asarray(j[4]))
    assert (N(t[2]) < 0).any()
    np.testing.assert_allclose(N(t[0]), np.asarray(j[0]), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(N(t[3]), np.asarray(j[3]), rtol=1e-6, atol=1e-6)
    # Covariance sandwiches: the two frameworks fuse the products differently.
    np.testing.assert_allclose(N(t[1]), np.asarray(j[1]), rtol=1e-4, atol=1e-9)


def _select_inputs(rng, c=256, levels=3, nb=5):
    par, pts, rb, pb = _keys_inputs(rng, c, levels)
    piw, covs, keys, vc, _ = (np.asarray(x) for x in j_mg.keys_call(
        *(jnp.asarray(x) for x in (par, pts, rb, pb)), levels=levels, capacity=1024,
        interpret=True, block=128))
    nc = 2 * levels
    plane = np.zeros((nc, 31, c), np.float32)
    vcs = vc.reshape(nc, 3, c)
    for m in range(nc):
        nrm = rng.normal(size=(3, c))
        nrm /= np.linalg.norm(nrm, axis=0, keepdims=True)
        plane[m, 0:3] = piw[3:6] - vcs[m] + rng.normal(scale=0.05, size=(3, c))
        plane[m, 3:6] = nrm
        plane[m, 9] = 0.3
        g = rng.normal(size=(c, 6, 6)) * 1e-3
        pv = g @ np.swapaxes(g, 1, 2)
        iu = np.triu_indices(6)
        plane[m, 10:31] = pv[:, iu[0], iu[1]].T
    flags = np.concatenate([rng.random((nc, c)) < 0.8, rng.random((nc, c)) < 0.7]).astype(np.float32)
    n_valid = c - 40
    mask = (np.arange(c) < n_valid).astype(np.float32)[None]
    bidx = np.minimum(np.arange(c) * nb // n_valid, nb).astype(np.float32)[None]
    par2 = np.asarray([[3.0, 3.0, 10.0, 0, 0, 0, 0, 0]], np.float32)
    return (par2, piw, covs[0:18], vc, plane.reshape(nc * 31, c), flags, mask, bidx), nb


def test_select_plain_matches_jax_kernel(rng):
    args, nb = _select_inputs(rng)
    j_out, j_s40, j_nm = j_mg.select_call(*(jnp.asarray(x) for x in args), levels=3,
                                          n_buckets=nb, interpret=True, block=128)
    t_out, t_s40, t_nm = t_mg.select_call(*(T(x) for x in args), 3, nb)
    matched = np.asarray(j_out[0])
    assert 0.2 < matched[:200].mean() < 0.95  # both gate outcomes exercised
    np.testing.assert_array_equal(N(t_out[0]), matched)
    np.testing.assert_array_equal(N(t_nm), np.asarray(j_nm))
    np.testing.assert_allclose(N(t_out), np.asarray(j_out), rtol=1e-5, atol=1e-6)
    # s40: sums over ~40 rows of products up to ~1e4; the JAX kernel sums by
    # an f32 matrix product, the plain version by index_add.
    np.testing.assert_allclose(N(t_s40), np.asarray(j_s40), rtol=1e-4, atol=1e-2)


def test_moments_plain_matches_jax_kernel(rng):
    r = 256
    par = np.zeros((1, 16), np.float32)
    par[0, 0:9] = np.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], np.float32).reshape(9)
    p_i = rng.normal(size=(r, 3)).astype(np.float32)
    rb = rotations(rng, r, 0.2)
    pb = rng.normal(size=(r, 3)).astype(np.float32)
    mats = [(x @ np.swapaxes(x, 1, 2) * s).astype(np.float32)
            for x, s in ((rng.normal(size=(r, 3, 3)), 0.01), (rng.normal(size=(r, 3, 3)), 0.001),
                         (rng.normal(size=(r, 3, 3)), 0.001))]
    keys = rng.integers(-20, 20, size=(r, 3)).astype(np.float32)
    size = np.full((1, r), 0.5, np.float32)
    prow = np.concatenate([p_i, mats[0].reshape(r, 9)], axis=1).T.copy()
    brow = np.concatenate([rb.reshape(r, 9), pb, mats[1].reshape(r, 9), mats[2].reshape(r, 9)], 1).T.copy()
    j = np.asarray(j_ir.moments_call(*(jnp.asarray(x) for x in (par, prow, brow, keys.T, size)),
                                     interpret=True, block=128))
    t = N(t_ir.moments_call(*(T(x) for x in (par, prow, brow, keys.T, size))))
    np.testing.assert_allclose(t[0:9], j[0:9], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t[9:69], j[9:69], rtol=1e-4, atol=1e-7)


def test_wrappers_count_only_kernel_launches():
    """On CPU tensors the wrappers run the plain versions and count nothing."""
    fns = (t_cs.chain_call, t_mg.keys_call, t_mg.select_call, t_ir.moments_call,
           t_pfr.fit_rows_call, t_pp.pose_call)
    before = [f.launches for f in fns]
    rng = np.random.default_rng(0)
    par, pts, rb, pb = _keys_inputs(rng, c=128)
    t_mg.keys_call(*(T(x) for x in (par, pts, rb, pb)), 3, 256)
    t_pfr.fit_rows_call(T(np.zeros(8, np.float32)), T(np.zeros((69, 128), np.float32)),
                        T(np.zeros((4, 128), np.float32)))
    t_pp.pose_call(T(np.zeros(32, np.float32)), T(np.zeros((9, 128), np.float32)))
    assert [f.launches for f in fns] == before


FIT_THRESHOLD = 0.01


def _fit_rows(rng, width):
    """Packed refit rows [width, 69] / [width, 4] and the kind of each row:
    planes of 5-40 points with the normal spread on either side of the
    planer threshold, near-collinear rows, rows with an exactly diagonal
    covariance, one-point rows, and all-zero padding."""
    moments, metas, kinds = [], [], []

    def add(pts, var, kind):
        m = j_pf.point_moments(jnp.asarray(pts, jnp.float32), jnp.asarray(var, jnp.float32))
        m = j_pf.PlaneMoments(*[jnp.sum(x, axis=0) for x in m])
        moments.append(np.concatenate([np.asarray(x) for x in j_vm._pack_moments(m._replace(n=None))]))
        metas.append([float(len(pts)), 3.0, 1.0, 0.0])
        kinds.append(kind)

    def covs(n, scale=0.01):
        a = rng.normal(size=(n, 3, 3)) * scale
        return a @ np.swapaxes(a, 1, 2) + 1e-6 * np.eye(3)

    for i in range(width // 2):
        n = int(rng.integers(5, 40)) if i % 3 else 40
        normal = rng.normal(size=3)
        normal /= np.linalg.norm(normal)
        basis = np.linalg.svd(np.eye(3) - np.outer(normal, normal))[0][:, :2]
        thick = 0.01 if i % 3 else 0.2   # lam_min ~1e-4 (plane) or ~2e-2 (not a plane)
        pts = rng.uniform(-0.3, 0.3, size=(n, 2)) @ basis.T + normal * rng.normal(scale=thick, size=(n, 1))
        add(pts + rng.normal(scale=0.05, size=3), covs(n), "plane" if i % 3 else "thick")
    for _ in range(8):
        n = int(rng.integers(6, 14))
        line = np.outer(np.linspace(-0.2, 0.2, n), rng.normal(size=3))
        add(line + rng.normal(scale=1e-5, size=(n, 3)), covs(n, 1e-3), "line")
    for _ in range(8):   # +-a along each axis: off-diagonal moments cancel exactly
        a = rng.uniform(0.05, 0.25, size=3) * [1.0, 1.0, 0.05]
        pts = np.concatenate([np.diag(a), -np.diag(a)])
        add(pts, covs(6), "diagonal")
    for _ in range(4):
        add(np.tile(rng.normal(scale=0.1, size=3), (6, 1)), covs(6), "point")
    k = len(moments)
    mom = np.zeros((width, 69), np.float32)
    meta = np.zeros((width, 4), np.float32)
    mom[:k], meta[:k] = np.stack(moments), np.asarray(metas)
    return mom, meta, kinds + ["zero"] * (width - k)


@pytest.mark.parametrize("width", [128, 256])
def test_fit_rows_plain_matches_jax_kernel_and_fit_planes(rng, width):
    mom, meta, kinds = _fit_rows(rng, width)
    kinds = np.asarray(kinds)
    par = np.zeros((1, 8), np.float32)
    par[0, 0] = FIT_THRESHOLD
    j_out = np.asarray(j_pfr.fit_rows_call(jnp.asarray(par), jnp.asarray(mom.T), jnp.asarray(meta.T),
                                           interpret=True, block=128)).T
    t_out = N(t_pfr.fit_rows_call(T(par[0]), T(mom.T), T(meta.T))).T
    fit = j_pf.fit_planes(
        j_vm._unpack_moments(jnp.asarray(mom[:, :9]), jnp.asarray(mom[:, 9:]),
                             jnp.maximum(jnp.asarray(meta[:, 0]), 1.0)), FIT_THRESHOLD)
    pv = np.asarray(fit.plane_var).reshape(-1, 36)[:, list(j_vm._TRIU36)]
    j_planes = np.concatenate([np.asarray(fit.center_rel), np.asarray(fit.normal), np.asarray(fit.evals),
                               np.asarray(fit.radius)[:, None], pv], axis=1)
    assert np.isfinite(t_out).all()                      # padding rows included
    assert (kinds == "diagonal").sum() == 8 and (kinds == "zero").sum() >= width // 4
    assert set(t_out[kinds == "plane", 34]) == {1.0} and set(t_out[kinds == "thick", 34]) == {0.0}
    np.testing.assert_array_equal(t_out[kinds == "zero", 31:35], [[0.0, 0.0, 1.0, 1.0]] * (kinds == "zero").sum())
    well = np.isin(kinds, ("plane", "thick"))
    # The tolerances of the JAX package's own kernel-vs-fit_planes test
    # (tests/test_plane_fit_pallas.py): centre, evals, radius 1e-5 on every
    # row; the meta row exact; normals 2e-4 and plane_var 5e-4 of its scale
    # on the well-conditioned rows only (a repeated eigenvalue leaves the
    # normal undetermined; there both must return a unit vector).  Two
    # exceptions, both rounding noise of a rank-deficient covariance: on a
    # line the closed form (acos near +-1) leaves ~1e-5 on the two small
    # eigenvalues, so 5e-5 there; on identical points the covariance is
    # cancellation noise (~1e-10, or exactly 0) and the radius its square
    # root, so 1e-4 there.
    some = kinds != "point"
    full = kinds != "line"
    for ref in (j_out[:, 0:31], j_planes):
        np.testing.assert_allclose(t_out[:, 0:3], ref[:, 0:3], atol=1e-5)
        np.testing.assert_allclose(t_out[full, 6:9], ref[full, 6:9], atol=1e-5)
        np.testing.assert_allclose(t_out[~full, 6:9], ref[~full, 6:9], atol=5e-5)
        np.testing.assert_allclose(t_out[some, 9], ref[some, 9], atol=1e-5)
        np.testing.assert_allclose(t_out[~some, 9], ref[~some, 9], atol=1e-4)
        np.testing.assert_allclose(t_out[well, 3:6], ref[well, 3:6], atol=2e-4)
        scale = np.maximum(1.0, np.abs(ref[well, 10:31]).max(axis=1, keepdims=True))
        np.testing.assert_allclose(t_out[well, 10:31] / scale, ref[well, 10:31] / scale, atol=5e-4)
    np.testing.assert_array_equal(t_out[:, 31:35], j_out[:, 31:35])
    np.testing.assert_array_equal(t_out[:, 34], np.asarray(fit.is_plane).astype(np.float32))
    np.testing.assert_allclose(np.linalg.norm(t_out[:, 3:6], axis=1), 1.0, atol=1e-4)
    # plane_var is multiplied by is_plane, as in the kernel.
    assert not t_out[kinds == "thick", 10:31].any()


def _pose_setup(rng, nb, k):
    """A carry with a moving, rotated state and a packet whose timeline has
    masked events (~60%) and masked buckets (~15%)."""
    from scipy.spatial.transform import Rotation

    bt = ((np.arange(nb) + 1) * 0.004).astype(np.float32)
    et = (bt[:, None] - 0.004 + 0.004 * (np.arange(k)[None, :] + 0.5) / k).astype(np.float32)
    acc = rng.normal(scale=0.5, size=(nb, k, 3)).astype(np.float32)
    acc[..., 2] += 9.81
    fields = dict(
        rebase=np.float32(0.1), end_offset=np.float32(nb * 0.004), bucket_time=bt,
        bucket_mask=rng.random(nb) < 0.85,
        points=np.zeros((nb, 4, 3), np.float32), point_mask=np.zeros((nb, 4), bool),
        imu_time=et, imu_mask=rng.random((nb, k)) < 0.4, imu_acc=acc,
        imu_gyr=rng.normal(scale=0.5, size=(nb, k, 3)).astype(np.float32),
        foot_pos=np.zeros((nb, k, 4, 3), np.float32), foot_vel=np.zeros((nb, k, 4, 3), np.float32),
        contact=np.zeros((nb, k, 4), bool),
    )
    mcfg = JMapConfig(levels=2, capacity=64, probe=4, voxel_size=0.5, planer_threshold=0.01,
                      sigma_num=3.0, max_points_num=50, init_num=(5, 5))
    jscfg = JStatic(map_cfg=mcfg, use_kin=False, dept_err=0.04, beam_err=0.2)
    jparams = JParams(noise=j_eskf.make_noise_params(JEskfConfig()), ext_r=jnp.eye(3),
                      ext_t=jnp.asarray([0.0, 0.0, 0.2]), g_over_acc_norm=jnp.asarray(1.002, jnp.float32))
    lin = rng.normal(scale=0.05, size=27).astype(np.float32)
    lin[0:3] = [1.0, -2.0, 0.3]
    lin[3:6] = [0.6, 0.1, -0.05]
    lin[12:15] = [0.0, 0.0, -9.81]
    lin[15:18] = [0.1, -0.2, 9.7]
    lin[18:21] = [0.3, -0.2, 0.5]
    jc = j_init_carry(jscfg)
    jc = jc._replace(
        state=jc.state._replace(rot=jnp.asarray(Rotation.from_rotvec([0.2, -0.1, 0.4]).as_matrix(), jnp.float32),
                                lin=jnp.asarray(lin)),
        last_predict_t=jnp.asarray(-0.003, jnp.float32))
    return jc, JPacket(**{f: jnp.asarray(v) for f, v in fields.items()}), jparams, fields


@pytest.mark.parametrize("nb,k,mp", [(28, 1, 128), (28, 5, 256), (28, 12, 384), (256, 4, 1280)])
def test_pose_plain_matches_jax_kernel_and_xla_path(rng, nb, k, mp):
    import jax

    jc, jpkt, jparams, fields = _pose_setup(rng, nb, k)
    assert (nb * (k + 1) + 127) // 128 * 128 == mp
    tc = convert.carry_from_numpy([np.asarray(x) for x in jax.tree.leaves(jc)], "cpu")
    tparams = convert.params_from_numpy([np.asarray(x) for x in jax.tree.leaves(jparams)], "cpu")
    tpkt = ScanPacket(**{f: T(v) for f, v in fields.items()})
    rb_t, pb_t = t_fd._predicted_bucket_poses_imu_kernel(tc, tpkt, tparams)
    rb_k, pb_k = j_fd._predicted_bucket_poses_imu_pallas(jc, jpkt, jparams)   # interpret on the CPU
    rb_x, pb_x = j_fd._predicted_bucket_poses_imu(jc, jpkt, jparams)
    rb_p, pb_p = t_fd._predicted_bucket_poses_imu(tc, tpkt, tparams)
    assert np.abs(N(pb_t) - np.asarray(jc.state.pos)).max() > 0.01    # the state moved
    # rtol 1e-5, atol 1e-6: the JAX package's own kernel-vs-XLA tolerance
    # (tests/test_pose_prop_pallas.py); the doubling scans and cumsum round
    # their sums in another order.  Past 1,024 slots (a 1.024 s timeline)
    # positions against JAX take atol 1e-5 m: XLA on the CPU contracts the
    # products into FMAs and eager torch does not, the rotation prefix
    # product parts by ~2e-6 after 1,280 factors, and the double integration
    # of a gravity-sized acceleration carries that into the positions
    # (measured 4.5e-6 m); each side's kernel still matches its own XLA form
    # at the shared tolerance (port 2.4e-7 m, JAX 5.4e-7 m).
    pos_atol = 1e-6 if mp <= 1024 else 1e-5
    for rb, pb in ((rb_k, pb_k), (rb_x, pb_x), (rb_p, pb_p)):
        np.testing.assert_allclose(N(rb_t), N(rb), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(N(pb_t), N(pb), rtol=1e-5, atol=1e-6 if pb is pb_p else pos_atol)
    np.testing.assert_allclose(np.asarray(pb_k), np.asarray(pb_x), rtol=1e-5, atol=1e-6)


def test_pose_plain_rows_match_jax_kernel_rows(rng):
    """Every slot of the [12, MP] output, padded lanes included, on rows
    built by hand: the kernels' own contract."""
    mp, m = 256, 200
    rows = np.zeros((9, mp), np.float32)
    rows[0, :m] = np.sort(rng.uniform(0.0, 0.1, size=m))
    rows[1, :m] = rng.random(m) < 0.7
    rows[2, :m] = (rng.random(m) < 0.5) * rows[1, :m]
    rows[3:9, :m] = rng.normal(scale=0.5, size=(6, m))
    rows[8, :m] += 9.81
    par = np.concatenate([np.eye(3).reshape(9), rng.normal(size=6), rng.normal(scale=0.01, size=6),
                          [0.0, 0.0, -9.81], rng.normal(scale=0.3, size=3), [0.0, 0.1, 9.8],
                          [-0.002, 0.999]]).astype(np.float32)
    j = np.asarray(j_pp.pose_call(jnp.asarray(par[None]), jnp.asarray(rows), interpret=True))
    t = N(t_pp.pose_call(T(par), T(rows)))
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)
    # Padded lanes are no-ops: they hold the last slot's pose, to the rounding
    # of the doubling tree (each lane multiplies the same factors in its own order).
    np.testing.assert_allclose(t[:, m:], np.repeat(t[:, m - 1:m], mp - m, axis=1), atol=1e-6)
