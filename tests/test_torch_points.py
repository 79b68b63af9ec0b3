"""The per-point path (``chain_impl="jax"``) of the port vs the JAX package, on the CPU.

Module by module and as a whole, the same seeded numpy inputs through the
JAX function and its counterpart in the port: the dot-product ESKF forms
(core/eskf.py), ``match_points``, the per-point chain's plain version
against ``_chain_jax`` and against the archived Pallas chain kernel itself
in interpret mode, and a few scans of ``process_scan_deferred`` scan by
scan.  The CUDA kernel runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py), held against the plain version there.

The archived kernel (tools/experiments/eskf_chain_pallas.py) uses
package-relative imports although it lives outside the package, so it is
loaded, unedited, under a module name inside ``legkilo_tpu.ops.pallas``.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import legkilo_tpu.ops.pallas  # noqa: F401  (the archived kernel's borrowed parent package)
from legkilo_tpu import config as j_config
from legkilo_tpu import runner as j_runner
from legkilo_tpu.config import EskfConfig as JEskfConfig
from legkilo_tpu.core import eskf as j_eskf
from legkilo_tpu.core import filter_deferred as j_fd
from legkilo_tpu.core import voxel_map as jv
from legkilo_tpu.core.filter import FilterParams as JParams, ScanPacket as JPacket
from legkilo_tpu.core.filter import StaticConfig as JStatic, init_carry as j_init_carry
from legkilo_tpu.core.state import State as JState
from legkilo_tpu.io import dataset as j_ds
from legkilo_tpu.models import sim as j_sim

from legkilo_torch import config as t_config
from legkilo_torch import convert
from legkilo_torch import runner as t_runner
from legkilo_torch.config import EskfConfig as TEskfConfig
from legkilo_torch.core import eskf as t_eskf
from legkilo_torch.core import filter_deferred as t_fd
from legkilo_torch.core import voxel_map as tv
from legkilo_torch.core.filter import ScanPacket
from legkilo_torch.core.state import State as TState
from legkilo_torch.io import dataset as t_ds
from legkilo_torch.models import sim as t_sim
from legkilo_torch.ops import chain_points as t_cp
from test_torch_kernels import _chain_setup
from test_torch_slice import CAPACITY_LOG2, _JAX_STEP, build_packets, make_cfg
from test_torch_voxel_map import cfgs, scene, to_port
from torch_util import N, T, assert_maps_match, one_thread  # noqa: F401

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------- (a) core/eskf.py --


def _state_cov(rng):
    from scipy.spatial.transform import Rotation

    rot = Rotation.from_rotvec(rng.normal(scale=0.3, size=3)).as_matrix().astype(np.float32)
    lin = rng.normal(scale=0.1, size=27).astype(np.float32)
    lin[12:15] = [0.0, 0.0, -9.81]
    lin[15:18] += [0.0, 0.0, 9.81]
    a = rng.normal(size=(30, 30))
    cov = (a @ a.T * 1e-4 + 1e-5 * np.eye(30)).astype(np.float32)
    return rot, lin, cov


def _both(rot, lin):
    return JState(rot=jnp.asarray(rot), lin=jnp.asarray(lin)), TState(rot=T(rot), lin=T(lin))


def _close(t_out, j_out, rtol=1e-5, atol=1e-6):
    """(state, cov) pairs to f32 rounding: ~1e-5 of each entry's scale."""
    (ts, tc), (js, jc) = t_out, j_out
    np.testing.assert_allclose(N(ts.rot), np.asarray(js.rot), rtol=rtol, atol=atol)
    np.testing.assert_allclose(N(ts.lin), np.asarray(js.lin), rtol=rtol, atol=1e-5)
    np.testing.assert_allclose(N(tc), np.asarray(jc), rtol=rtol, atol=atol * float(np.abs(jc).max()) * 10)


def test_eskf_inv6_matches_jax(rng):
    a = rng.normal(size=(5, 6, 6))
    m = (a @ np.swapaxes(a, 1, 2) + np.eye(6)).astype(np.float32)
    got = N(t_eskf.inv6(T(m)))
    np.testing.assert_allclose(got, np.asarray(j_eskf.inv6(jnp.asarray(m))), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got @ m, np.broadcast_to(np.eye(6), m.shape), atol=1e-4)


@pytest.mark.parametrize("dts", [(0.004, 0.004), (0.002, 0.05), (0.0, 0.0)])
def test_eskf_predict_matches_jax(rng, dts):
    rot, lin, cov = _state_cov(rng)
    js, ts = _both(rot, lin)
    q = rng.uniform(1e-4, 1e-2, size=30).astype(np.float32)
    dm, dc = (np.float32(x) for x in dts)
    j_out = j_eskf.predict(js, jnp.asarray(cov), jnp.asarray(q), jnp.asarray(dm), jnp.asarray(dc))
    t_out = t_eskf.predict(ts, T(cov), T(q), torch.tensor(dm), torch.tensor(dc))
    _close(t_out, j_out)
    np.testing.assert_allclose(N(t_eskf.transition_fx(ts, torch.tensor(dc))),
                               np.asarray(j_eskf.transition_fx(js, jnp.asarray(dc))), atol=1e-6)
    np.testing.assert_allclose(N(t_eskf.transition_f(ts, torch.tensor(dm))),
                               np.asarray(j_eskf.transition_f(js, jnp.asarray(dm))), atol=1e-6)


def test_eskf_update_by_points_matches_jax(rng):
    """Also batched over a leading dim, and the empty update as an exact no-op."""
    rot, lin, cov = _state_cov(rng)
    js, ts = _both(rot, lin)
    n = 64
    h6 = rng.normal(size=(n, 6)).astype(np.float32)
    z = rng.normal(scale=0.05, size=n).astype(np.float32)
    r = rng.uniform(1e-3, 5e-2, size=n).astype(np.float32)
    mask = rng.random(n) < 0.7
    j_out = j_eskf.update_by_points(js, jnp.asarray(cov), *(jnp.asarray(x) for x in (h6, z, r, mask)))
    t_out = t_eskf.update_by_points(ts, T(cov), *(T(x) for x in (h6, z, r, mask)))
    _close(t_out, j_out, rtol=2e-5)
    st0, cov0 = t_eskf.update_by_points(ts, T(cov), T(h6), T(z), T(r), torch.zeros(n, dtype=torch.bool))
    np.testing.assert_array_equal(N(cov0), cov)
    np.testing.assert_array_equal(N(st0.lin), lin)
    tb = TState(rot=T(np.stack([rot, rot])), lin=T(np.stack([lin, lin])))
    sb, cb = t_eskf.update_by_points(tb, T(np.stack([cov, cov])), *(T(np.stack([x, x])) for x in (h6, z, r, mask)))
    np.testing.assert_allclose(N(cb[1]), N(t_out[1]), rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(N(sb.lin[0]), N(t_out[0].lin), atol=1e-6)


@pytest.mark.parametrize("gate", [1.0, 0.0])
def test_eskf_update_by_imu_matches_jax(rng, gate):
    rot, lin, cov = _state_cov(rng)
    js, ts = _both(rot, lin)
    acc = (rng.normal(scale=0.05, size=3) + [0, 0, 9.81]).astype(np.float32)
    gyr = rng.normal(scale=0.02, size=3).astype(np.float32)
    r6 = np.asarray(j_eskf.make_noise_params(JEskfConfig()).imu_meas_r)
    jz = j_eskf.imu_innovation(js, jnp.asarray(acc), jnp.asarray(gyr), jnp.asarray(1.0))
    tz = t_eskf.imu_innovation(ts, T(acc), T(gyr), torch.tensor(1.0))
    j_out = j_eskf.update_by_imu(js, jnp.asarray(cov), jz, jnp.asarray(r6), gate=jnp.asarray(np.float32(gate)))
    t_out = t_eskf.update_by_imu(ts, T(cov), tz, T(r6), gate=torch.tensor(gate))
    _close(t_out, j_out, rtol=2e-5)
    if gate == 0.0:
        np.testing.assert_array_equal(N(t_out[1]), cov)


@pytest.mark.parametrize("contact", [(1, 1, 0, 1), (0, 0, 0, 0)])
def test_eskf_kin_obs_and_update_match_jax(rng, contact):
    rot, lin, cov = _state_cov(rng)
    js, ts = _both(rot, lin)
    acc = (rng.normal(scale=0.05, size=3) + [0, 0, 9.81]).astype(np.float32)
    gyr = rng.normal(scale=0.02, size=3).astype(np.float32)
    fp = rng.normal(scale=0.2, size=(4, 3)).astype(np.float32)
    fv = rng.normal(scale=0.1, size=(4, 3)).astype(np.float32)
    ct = np.asarray(contact, bool)
    jn = j_eskf.make_noise_params(JEskfConfig())
    tn = t_eskf.make_noise_params(TEskfConfig(), "cpu")
    jh = j_eskf.build_kin_obs(js, *(jnp.asarray(x) for x in (acc, gyr, fp, fv, ct)), jn, jnp.asarray(1.0))
    th = t_eskf.build_kin_obs(ts, *(T(x) for x in (acc, gyr, fp, fv, ct)), tn, torch.tensor(1.0))
    for a, b in zip(th, jh):
        np.testing.assert_allclose(N(a), np.asarray(b), rtol=1e-5, atol=1e-6)
    j_out = j_eskf.update_by_kin_imu(js, jnp.asarray(cov), *jh[0:3], gate=jnp.asarray(np.float32(1.0)))
    t_out = t_eskf.update_by_kin_imu(ts, T(cov), *th[0:3], gate=torch.tensor(1.0))
    # The 18x18 nested-Schur inverse amplifies the rounding of its products.
    _close(t_out, j_out, rtol=2e-4, atol=1e-5)


# ------------------------------------------------------ (b) match_points --


def test_match_points_matches_jax(rng):
    """A map built by ``insert_points`` on the JAX side and copied to the
    port, then the same query points through both ``match_points``.  The
    gates (sigma, range, best probability, the quarter-voxel neighbour
    offset) flip on the last ulp, so ``matched`` is held by the count of
    flips (at most 1 % of the rows) and the fields are compared where both
    matched the same plane."""
    jc, tc = cfgs(levels=3, capacity=512, insert_rounds=4)
    p, var, mask = scene(rng, 1600)
    perm = rng.permutation(len(p))
    p, var, mask = p[perm], var[perm], mask[perm]
    jvm = jv.insert_points(jv.make_map(jc), jc, *(jnp.asarray(x) for x in (p[:1000], var[:1000], mask[:1000])))
    tvm = to_port(jvm)
    q = p[1000:] + rng.normal(scale=0.004, size=(600, 3)).astype(np.float32)
    qv, qm = var[1000:] * 0.05, mask[1000:]
    jm = jv.match_points(jvm, jc, jnp.asarray(q), jnp.asarray(qv), jnp.asarray(qm))
    tm = tv.match_points(tvm, tc, T(q), T(qv), T(qm))

    # The own-chain probe is integer work: exact.
    for f in ("own_keys", "own_slot", "own_found", "own_plane"):
        np.testing.assert_array_equal(N(getattr(tm, f)), np.asarray(getattr(jm, f)), err_msg=f)
    jmat, tmat = np.asarray(jm.matched), N(tm.matched)
    assert jmat.sum() > 150 and not jmat[~qm].any() and not tmat[~qm].any()
    assert (jmat != tmat).sum() <= 0.01 * len(q)
    both = jmat & tmat
    same = both & (np.abs(N(tm.center) - np.asarray(jm.center)).max(axis=1) < 1e-5)
    assert same.sum() >= 0.99 * both.sum()
    for f, tol in (("normal", 1e-6), ("center", 1e-5), ("signed_dist", 1e-5)):
        np.testing.assert_allclose(N(getattr(tm, f))[same], np.asarray(getattr(jm, f))[same], atol=tol, err_msg=f)
    pv_j = np.asarray(jm.plane_var)[same]
    np.testing.assert_allclose(N(tm.plane_var)[same], pv_j, rtol=1e-6, atol=1e-12)
    # A missed slot reads zeros: rows that matched nothing carry a zero plane
    # or a gated-out candidate, never garbage.
    assert np.isfinite(N(tm.normal)).all() and np.isfinite(N(tm.plane_var)).all()


# ------------------------------------------------ (c), (d) the chain ------


def _points_chain_setup(rng, use_kin, nb, p, k):
    """test_torch_kernels' chain inputs with one bucket whose points all miss
    and one gated-off bucket; returns the JAX and the port's arguments of
    ``_chain_jax`` / ``run_chain``."""
    cov, fields, _, _ = _chain_setup(rng, use_kin, nb=nb, p=p, k=k)
    fields["bucket_mask"][1] = False
    normal = np.zeros((nb, p, 3), np.float32)
    normal[..., 2] = 1.0
    tilt = rng.normal(scale=0.05, size=(nb, p, 2)).astype(np.float32)
    normal[..., 0:2] = tilt
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    center = rng.uniform(-1, 1, size=(nb, p, 3)).astype(np.float32)
    center[..., 2] = 0.2 + rng.normal(scale=0.02, size=(nb, p)).astype(np.float32)
    matched = (rng.random((nb, p)) < 0.7) & fields["point_mask"]
    matched[nb - 2] = False
    r_meas = rng.uniform(0.01, 0.1, size=(nb, p)).astype(np.float32)
    p_i = fields["points"] + np.asarray([0.0, 0.0, 0.2], np.float32)
    p_i[..., 2] = 0.2 + rng.normal(scale=0.02, size=(nb, p)).astype(np.float32)
    rows = (p_i, normal, center, r_meas, matched)

    mcfg = jv.MapConfig(levels=2, capacity=256, probe=4, voxel_size=0.5, planer_threshold=0.01,
                        sigma_num=3.0, max_points_num=50, init_num=(5, 5))
    jscfg = JStatic(map_cfg=mcfg, use_kin=use_kin, dept_err=0.04, beam_err=0.2)
    jparams = JParams(noise=j_eskf.make_noise_params(JEskfConfig()), ext_r=jnp.eye(3),
                      ext_t=jnp.asarray([0.0, 0.0, 0.2]), g_over_acc_norm=jnp.asarray(1.0))
    jcarry = j_init_carry(jscfg)._replace(cov=jnp.asarray(cov))
    jpkt = JPacket(**{f: jnp.asarray(v) for f, v in fields.items()})
    tcarry = convert.carry_from_numpy([np.asarray(x) for x in jax.tree.leaves(jcarry)], "cpu")
    tparams = convert.params_from_numpy([np.asarray(x) for x in jax.tree.leaves(jparams)], "cpu")
    tpkt = ScanPacket(**{f: T(v) for f, v in fields.items()})
    return (jcarry, jpkt, jparams, jscfg), (tcarry, tpkt, tparams), rows


def _assert_chain_close(t_out, j_out, atol_pose, atol_cov):
    for a, b, tol in zip(t_out[1:5], j_out[1:5], (atol_pose, atol_pose, atol_cov, atol_cov)):
        np.testing.assert_allclose(N(a), np.asarray(b), atol=tol)
    np.testing.assert_array_equal(N(t_out[5]), np.asarray(j_out[5]))
    tc, jc = t_out[0], j_out[0]
    np.testing.assert_allclose(N(tc.state.lin), np.asarray(jc.state.lin), atol=max(1e-4, atol_pose))
    np.testing.assert_allclose(N(tc.state.rot), np.asarray(jc.state.rot), atol=atol_pose)
    np.testing.assert_allclose(N(tc.cov), np.asarray(jc.cov), atol=atol_cov)
    np.testing.assert_allclose(float(tc.last_predict_t), float(jc.last_predict_t), atol=1e-6)
    np.testing.assert_allclose(float(tc.last_update_t), float(jc.last_update_t), atol=1e-6)


@pytest.mark.parametrize("use_kin", [False, True], ids=["imu", "kin"])
def test_chain_points_plain_matches_chain_jax(rng, use_kin):
    """``run_chain`` on CPU tensors (the plain version) against the JAX
    package's ``_chain_jax``: the same recursion on the same dot-product
    forms, so the tolerances of the fused chain's test (3e-5 poses, 2e-4
    covariances; the kin branch looser for its 18x18 inverse).  Bucket 1 is
    gated off and bucket NB-2 has no matched point: both leave the state as
    the predict left it and do not move the update clock."""
    nb, p, k = 6, 32, 2
    (jcarry, jpkt, jparams, jscfg), (tcarry, tpkt, tparams), rows = _points_chain_setup(rng, use_kin, nb, p, k)
    j_out = jax.jit(j_fd._chain_jax, static_argnums=3)(jcarry, jpkt, jparams, jscfg, *(jnp.asarray(x) for x in rows))
    n0 = t_cp.chain_points_call.launches
    t_out = t_cp.run_chain(tcarry, tpkt, tparams, *(T(x) for x in rows), use_kin=use_kin)
    assert t_cp.chain_points_call.launches == n0          # a CPU tensor launches nothing
    atol_pose, atol_cov = (1e-4, 5e-4) if use_kin else (3e-5, 2e-4)
    _assert_chain_close(t_out, j_out, atol_pose, atol_cov)
    nm = N(t_out[5])
    assert nm[1] == 0 and nm[nb - 2] == 0 and nm.sum() > 50 and t_out[5].dtype == torch.int32
    # The empty bucket's pose is its predecessor's moved by the predict only.
    assert np.abs(N(t_out[2])[nb - 2] - N(t_out[2])[nb - 3]).max() < 1e-3


@pytest.fixture(scope="module")
def archived_chain():
    """tools/experiments/eskf_chain_pallas.py, loaded as it stands."""
    name = "legkilo_tpu.ops.pallas._archived_eskf_chain"
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_ROOT, "tools", "experiments", "eskf_chain_pallas.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
        yield mod
    finally:
        sys.modules.pop(name, None)


@pytest.mark.parametrize("use_kin", [False, True], ids=["imu", "kin"])
def test_chain_points_plain_matches_archived_pallas_kernel(rng, archived_chain, use_kin):
    """The plain version against the TPU kernel it stands for, run in
    interpret mode through its own ``run_chain`` (NB = 3, K = 1,
    P = 128).  The kernel inverts by Gauss-Jordan without pivoting and
    applies the predict as Q1 + (D Q1^T)^T, the plain version uses the
    closed-form Schur inverses and F P F^T: 1e-4 poses and 5e-4 covariances
    (IMU), 3e-4 and 1e-3 with the 18x18 kinematic inverse."""
    nb, p, k = 3, 128, 1
    (jcarry, jpkt, jparams, _), (tcarry, tpkt, tparams), rows = _points_chain_setup(rng, use_kin, nb, p, k)
    j_out = archived_chain.run_chain(jcarry, jpkt, jparams, *(jnp.asarray(x) for x in rows), use_kin=use_kin)
    t_out = t_cp.run_chain(tcarry, tpkt, tparams, *(T(x) for x in rows), use_kin=use_kin)
    atol_pose, atol_cov = (3e-4, 1e-3) if use_kin else (1e-4, 5e-4)
    _assert_chain_close(t_out, j_out, atol_pose, atol_cov)
    assert N(t_out[5])[1] == 0 and N(t_out[5])[0] > 30


def test_chain_points_call_contract_on_cpu(rng):
    """The flattened kernel contract: shapes of the nine outputs, and the
    gating of the point update by ``did`` (an all-masked call changes the
    state only by its predicts and IMU updates, whatever the rows hold)."""
    nb, p, k = 4, 16, 1
    _, (tcarry, tpkt, tparams), rows = _points_chain_setup(rng, False, nb, p, k)
    p_i, normal, center, r_meas, matched = (T(x) for x in rows)
    none = torch.zeros_like(matched)
    a = t_cp.run_chain(tcarry, tpkt, tparams, p_i, normal, center, r_meas, none)
    b = t_cp.run_chain(tcarry, tpkt, tparams, p_i * 3.0, normal, center + 1.0, r_meas * 0.0, none)
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(N(x), N(y))
    np.testing.assert_array_equal(N(a[0].cov), N(b[0].cov))
    assert [tuple(x.shape) for x in a[1:]] == [(nb, 3, 3), (nb, 3), (nb, 3, 3), (nb, 3, 3), (nb,)]
    assert int(a[5].sum()) == 0


# ------------------------------------------------- (e) the slice as a whole --

N_SCANS = 3


def points_cfg(mod, use_kin=False, match_cap=1024):
    """test_torch_slice's small cut of the bench workload on the per-point
    path, with the pose and refit kernels on; the chain, match and insert
    switches are off: that path does not read them."""
    cfg = make_cfg(mod, use_kin, five=True)
    cfg.tpu.chain_impl = "jax"
    cfg.tpu.use_pallas = cfg.tpu.use_pallas_match = cfg.tpu.use_pallas_insert = False
    cfg.tpu.match_cap = match_cap
    return cfg


@pytest.fixture(scope="module")
def points_run():
    """Init and N_SCANS per-point steps on both sides from the same packets;
    then scan N_SCANS + 1 on the port from the JAX carry (a shared state)."""
    data = j_sim.simulate(j_sim.SimConfig(duration=(N_SCANS + 3) * 0.1, scan_points=2500, seed=11))
    jcfg, tcfg = points_cfg(j_config), points_cfg(t_config)
    jraw, jp = build_packets(j_ds, jcfg, data)
    traw, tp = build_packets(t_ds, tcfg, data)
    jr = j_runner.OdometryRunner(jcfg)
    tr = t_runner.OdometryRunner(tcfg, device="cpu")
    jr._initialize(jraw[0], jp[0])
    tr._initialize(traw[0], tp[0])
    jc, tc, steps = jr.carry, tr.carry, []
    for i in range(1, N_SCANS + 1):
        jc, jo = _JAX_STEP(jc, j_ds.to_device_packet(jp[i]), jr.params, jr.scfg)
        tc, to = t_fd.process_scan_deferred(tc, t_ds.to_device_packet(tp[i], "cpu"), tr.params, tr.scfg)
        steps.append((jax.tree.map(np.asarray, jo), to))
    shared = convert.carry_from_numpy([np.asarray(x) for x in jax.tree.leaves(jc)], "cpu")
    jc2, jo2 = _JAX_STEP(jc, j_ds.to_device_packet(jp[N_SCANS + 1]), jr.params, jr.scfg)
    tc2, to2 = t_fd.process_scan_deferred(
        shared, t_ds.to_device_packet(tp[N_SCANS + 1], "cpu"), tr.params, tr.scfg)
    return dict(steps=steps, final=(jc, tc), shared=shared, one=(jc2, jax.tree.map(np.asarray, jo2), tc2, to2),
                jr=jr, tr=tr, jp=jp, tp=tp)


def test_points_slice_tracks_jax_scan_by_scan(points_run):
    """Three scans of ``process_scan_deferred`` with ``chain_impl="jax"`` on
    both sides.  The first step, from the same first-frame map, agrees to
    rounding (5e-5 m).  Later the two part by rounding fed back through the
    map (see test_torch_slice); the JAX package holds its own fused and
    per-point chains to 2 cm of each other (tests/test_eskf_fused.py), and
    the port stays within a tenth of that, 2 mm, of the JAX per-point
    path over these scans."""
    for i, (jo, to) in enumerate(points_run["steps"], start=1):
        tol = 5e-5 if i == 1 else 2e-3
        np.testing.assert_allclose(N(to.pos), jo.pos, atol=tol, err_msg=f"scan {i}")
        np.testing.assert_allclose(N(to.rot), jo.rot, atol=tol, err_msg=f"scan {i}")
        assert int(N(to.n_points)) == int(jo.n_points)
        assert int(N(to.n_cap_dropped)) == int(jo.n_cap_dropped)
        assert abs(int(N(to.n_matched)) - int(jo.n_matched)) <= max(3, 0.03 * int(jo.n_matched))
    assert int(points_run["steps"][-1][0].n_matched) > 100


def test_points_one_step_from_shared_state_matches_jax(points_run):
    """The JAX carry of the per-point path converts leaf for leaf (the same
    FilterCarry as the fused path's), and one step of the port from it gives
    the JAX step's pose to 2e-4 and the same map by key."""
    jc, _ = points_run["final"]
    for a, b in zip(convert.carry_to_numpy(points_run["shared"]), jax.tree.leaves(jc)):
        np.testing.assert_array_equal(a, np.asarray(b))
    jc2, jo2, tc2, to2 = points_run["one"]
    np.testing.assert_allclose(N(to2.pos), jo2.pos, atol=2e-4)
    np.testing.assert_allclose(N(to2.rot), jo2.rot, atol=2e-4)
    assert abs(int(N(to2.n_matched)) - int(jo2.n_matched)) <= 2
    np.testing.assert_array_equal(N(to2.map_overflow), jo2.map_overflow)
    np.testing.assert_allclose(N(tc2.cov), np.asarray(jc2.cov), atol=1e-6)
    assert_maps_match(jc2.vm, tc2.vm, 1 << CAPACITY_LOG2, exact_slots=False, mom_rtol=1e-4)


@pytest.mark.parametrize("match_cap,insert_cap", [(0, 0), (1100, 900), (1024, 1024)])
def test_batched_match_branches_agree(points_run, match_cap, insert_cap):
    """``_batched_match`` compacted at ``match_cap`` (not a multiple of 128:
    this path takes any cap) and over the full [NB, P] layout give the same
    rows where the point is valid, and zeros with no match elsewhere: the
    scatter back drops the unfilled slots instead of writing them anywhere."""
    tr, pkt = points_run["tr"], t_ds.to_device_packet(points_run["tp"][N_SCANS + 1], "cpu")
    carry = points_run["shared"]
    scfg = tr.scfg._replace(match_cap=match_cap, insert_cap=insert_cap)
    t_fd.check_supported(scfg, *pkt.points.shape[0:2])
    full = t_fd._batched_match(carry, pkt, tr.params, tr.scfg._replace(match_cap=0))
    got = t_fd._batched_match(carry, pkt, tr.params, scfg)
    valid = N(pkt.point_mask & pkt.bucket_mask[:, None])
    assert valid.sum() < 1024                                  # no valid row is beyond a cap
    np.testing.assert_array_equal(N(got[4]), N(full[4]))
    hit = N(full[4])
    assert not hit[~valid].any()
    # Fields where the point matched.  The variance form J plane_var J^T
    # cancels (its terms reach 1e3 times their sum on a plane met far from
    # its centre) and the two branches contract it in different orders, so
    # r_meas agrees to 5e-3 of its value where it is large and to rounding
    # elsewhere; normal and centre are gathers.
    for a, b, name, rtol in zip(got[1:4], full[1:4], ("normal", "center", "r_meas"), (0, 0, 5e-3)):
        np.testing.assert_allclose(N(a)[hit], N(b)[hit], rtol=rtol, atol=1e-7, err_msg=name)
        if match_cap:
            assert not N(a)[~valid].any(), name
    np.testing.assert_array_equal(N(got[0]), N(full[0]))
    assert N(got[4]).sum() > 100
    # The whole step runs with these caps and reports no dropped point.
    _, out = t_fd.process_scan_deferred(carry, pkt, tr.params, scfg)
    assert int(out.n_cap_dropped) == 0 and np.isfinite(N(out.pos)).all()


def test_points_cap_overflow_is_counted(points_run):
    """Valid points beyond the smaller cap are left unmatched and counted."""
    tr, pkt = points_run["tr"], t_ds.to_device_packet(points_run["tp"][N_SCANS + 1], "cpu")
    scfg = tr.scfg._replace(match_cap=300, insert_cap=500)
    _, out = t_fd.process_scan_deferred(points_run["shared"], pkt, tr.params, scfg)
    assert int(out.n_cap_dropped) == int(out.n_points) - 300 > 0
    assert int(out.n_matched) <= 300


@pytest.fixture(scope="module")
def points_sim():
    return t_sim.simulate(t_sim.SimConfig(duration=1.2, scan_points=2000, seed=5))


def test_points_run_offline_chunked_equals_streaming(points_sim):
    """``run_offline`` streaming and ``chunk=4`` on the per-point path give
    the same trajectory, bit for bit on the CPU."""
    cfg = points_cfg(t_config)
    cfg.tpu.escalate_after = 0          # chunked replay runs no escalation latch
    a = t_runner.run_offline(cfg, points_sim.scans, points_sim.imu, device="cpu")
    b = t_runner.run_offline(cfg, points_sim.scans, points_sim.imu, device="cpu", chunk=4)
    assert len(a) == len(b) >= 10
    for ra, rb in zip(a, b):
        np.testing.assert_array_equal(ra.pos, rb.pos)
        np.testing.assert_array_equal(ra.rot, rb.rot)
        assert (ra.n_matched, ra.n_points) == (rb.n_matched, rb.n_points)
    assert a[-1].n_matched > 100


def test_points_kin_and_escalated_runs(points_sim):
    """The kin branch and the escalated configuration (three match passes
    from the scan-start carry) through the runner: finite poses that track
    the sim's ground truth."""
    from legkilo_torch.io.tum import ate_rmse

    _, gt = points_sim.gt_in_filter_frame()
    gtm = {round(t, 6): i for i, t in enumerate(points_sim.gt_times)}
    for use_kin, iters in ((True, 1), (False, 3)):
        cfg = points_cfg(t_config, use_kin)
        cfg.tpu.match_iters = iters
        res = t_runner.run_offline(cfg, points_sim.scans, points_sim.kin if use_kin else points_sim.imu,
                                   device="cpu")
        pairs = [(r.pos, gt[gtm[round(r.time, 6)]]) for r in res if round(r.time, 6) in gtm]
        ate = ate_rmse(np.stack([x for x, _ in pairs]), np.stack([g for _, g in pairs]), align=False)
        assert len(res) >= 10 and ate < 0.08 and res[-1].n_matched > 100


def test_cli_sim_config_file_runs_the_per_point_path(tmp_path, capsys):
    """``sim --config_file`` with ``tpu_chain_impl: jax`` and every kernel
    switch left off runs as written on the CPU."""
    from legkilo_torch import cli
    from legkilo_torch.ops import chain_stats

    path = tmp_path / "points.yaml"
    path.write_text("tpu_pipeline: deferred\ntpu_chain_impl: jax\n")
    assert cli.main(["sim", "--device", "cpu", "--config_file", str(path),
                     "--duration", "1.0", "--scan_points", "2000"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["scans"] >= 8 and line["ate_rmse_m"] < 0.08
    assert chain_stats.chain_call.launches == 0


def test_bench_config_points_is_bench_py_on_the_per_point_path():
    cfg, base = t_runner.bench_config_points(), t_runner.bench_config()
    assert cfg.tpu.chain_impl == "jax" and cfg.tpu.use_pallas_pose and cfg.tpu.use_pallas_refit
    cfg.tpu.chain_impl = base.tpu.chain_impl
    assert cfg == base
    t_runner.OdometryRunner(t_runner.bench_config_points(), device="cpu")   # accepted as it stands
