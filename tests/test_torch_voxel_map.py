"""legkilo_torch voxel map vs the JAX package: hash, claims, insert, by key.

Maps are compared slot for slot where the claim rule makes them identical
(both apply duplicate claims last-writer-wins), and by key (key-sorted
meta/mom/moms/plane rows) otherwise.  The miss paths (masked rows, full
probe chains, rows beyond the caps) are part of every case.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from legkilo_tpu.core import plane_fit as j_pf
from legkilo_tpu.core import voxel_map as jv

from legkilo_torch.core import voxel_map as tv
from torch_util import N, T, assert_maps_match, one_thread  # noqa: F401


def cfgs(**kw):
    base = dict(levels=3, capacity=256, probe=4, voxel_size=0.5, planer_threshold=0.01,
                sigma_num=3.0, max_points_num=50, init_num=(5, 5, 5), insert_rounds=2,
                refit_budget=256)
    base.update(kw)
    return jv.MapConfig(**base), tv.MapConfig(**base)


def to_port(vm):
    return tv.VoxelMap(*(T(np.asarray(x)) for x in vm))


def scene(rng, n=600):
    """Points on three planes plus scatter, with world covariances."""
    pts = []
    for normal, off in (((0, 0, 1), 0.1), ((1, 0, 0), 1.3), ((0, 1, 0), -1.2)):
        m = n // 4
        uv = rng.uniform(-1, 1, size=(m, 3))
        uv[:, np.argmax(normal)] = off + rng.normal(scale=0.003, size=m)
        pts.append(uv)
    pts.append(rng.uniform(-2, 2, size=(n - 3 * (n // 4), 3)))
    p = np.concatenate(pts).astype(np.float32)
    a = rng.normal(size=(len(p), 3, 3)) * 0.01
    var = (a @ np.swapaxes(a, 1, 2) + 1e-6 * np.eye(3)).astype(np.float32)
    mask = rng.random(len(p)) < 0.9
    return p, var, mask


def test_hash_wraps_negative_keys_like_jax(rng):
    keys = rng.integers(-(2 ** 31), 2 ** 31 - 1, size=(4000, 3), dtype=np.int64).astype(np.int32)
    keys[:6] = [[-1, -1, -1], [-(2 ** 31), 0, 5], [2 ** 31 - 1, -7, 0], [0, 0, 0], [-3, 4, -5], [1, 2, 3]]
    for cap in (16, 1 << 14):
        np.testing.assert_array_equal(
            N(tv._hash(T(keys), cap)), np.asarray(jv._hash(jnp.asarray(keys), cap))
        )


@pytest.mark.parametrize("cap", [64, 700])
def test_compact_order_matches_jax(rng, cap):
    mask = rng.random(500) < 0.4
    np.testing.assert_array_equal(
        N(tv.compact_order(T(mask), cap)), np.asarray(jv.compact_order(jnp.asarray(mask), cap))
    )


def test_gather_fill_reads_fill_on_miss():
    x = torch.arange(12.0).reshape(4, 3)
    got = tv._gather_fill(x, torch.tensor([0, 4, 3, 4]), -1.0)
    np.testing.assert_array_equal(N(got)[[1, 3]], -1.0)
    np.testing.assert_array_equal(N(got)[[0, 2]], N(x)[[0, 3]])


@pytest.mark.parametrize("storage", ["f32", "f16"])
def test_insert_points_matches_jax(rng, storage):
    jc, tc = cfgs(storage_dtype=storage)
    p, var, mask = scene(rng)
    jvm = jv.make_map(jc)
    tvm = tv.make_map(tc, "cpu")
    for chunk in np.array_split(np.arange(len(p)), 3):  # three scans
        args = (p[chunk], var[chunk], mask[chunk])
        jvm = jv.insert_points(jvm, jc, *(jnp.asarray(x) for x in args))
        tvm = tv.insert_points(tvm, tc, *(T(x) for x in args))
    assert int(N(tvm.ocnt)[tv.OCNT_CLAIM]) > 0   # full probe chains: misses
    assert N(tvm.meta)[:, 3].sum() > 10          # planes formed
    if storage == "f32":
        assert_maps_match(jvm, tvm, jc.capacity)
    else:  # f16 tables: the JAX and torch f16 adds round the same sums alike
        np.testing.assert_array_equal(N(tvm.ptab), np.asarray(jvm.ptab))
        np.testing.assert_array_equal(N(tvm.meta), np.asarray(jvm.meta))
        np.testing.assert_allclose(N(tvm.moms).astype(np.float64),
                                   np.asarray(jvm.moms).astype(np.float64), rtol=2e-3, atol=1e-6)


def test_duplicate_claims_last_writer_wins(rng):
    """Distinct keys whose probe chains start on the same empty slot: one
    claim round, so only the winner of each slot gets in (the others count
    as failed claims), exactly as XLA applies the JAX scatter."""
    jc, tc = cfgs(levels=1, capacity=16, probe=1, init_num=(5,), insert_rounds=1)
    cand = np.stack(np.meshgrid(*[np.arange(-8, 8)] * 3, indexing="ij"), -1).reshape(-1, 3)
    h = N(tv._hash(T(cand.astype(np.int32)), 16))
    keys = np.concatenate([cand[h == 3][:4], cand[h == 9][:3]]).astype(np.int32)
    pts = ((keys + 0.5) * 0.5).astype(np.float32)
    var = np.tile(np.eye(3, dtype=np.float32) * 1e-4, (len(keys), 1, 1))
    mask = np.ones(len(keys), bool)
    jvm = jv.insert_points(jv.make_map(jc), jc, *(jnp.asarray(x) for x in (pts, var, mask)))
    tvm = tv.insert_points(tv.make_map(tc, "cpu"), tc, *(T(x) for x in (pts, var, mask)))
    np.testing.assert_array_equal(N(tvm.ptab), np.asarray(jvm.ptab))
    np.testing.assert_array_equal(N(tvm.ocnt), [0, 0, 5])
    assert N(tvm.ptab)[3, 0:3].tolist() == keys[3].tolist()   # last of the four
    np.testing.assert_array_equal(N(tvm.meta), np.asarray(jvm.meta))


def test_gated_packed_insert_matches_jax(rng):
    """The insert phase's path: match-probe results -> ancestor-gated rows
    (row cap overflowing) -> packed moment rows -> claims, scatter-adds and
    a refit budget that overflows too."""
    jc, tc = cfgs(insert_row_cap=256, refit_budget=8, insert_rounds=1)
    p, var, mask = scene(rng, 800)
    perm = rng.permutation(len(p))
    p, var, mask = p[perm], var[perm], mask[perm]
    jvm = jv.insert_points(jv.make_map(jc), jc, *(jnp.asarray(x) for x in (p[:400], var[:400], mask[:400])))
    tvm = to_port(jvm)
    q, qv, qm = p[400:], var[400:], mask[400:]
    m = jv.match_points(jvm, jc, jnp.asarray(q), jnp.asarray(qv), jnp.asarray(qm))
    own = [np.asarray(x) for x in (m.own_keys, m.own_slot, m.own_found, m.own_plane)]
    jrows = jv.gated_insert_rows(jc, jnp.asarray(qm), *(jnp.asarray(x) for x in own))
    trows = tv.gated_insert_rows(tc, T(qm), *(T(x) for x in own))
    for f in ("order", "pidx", "keys", "lvl", "mask", "found", "slot0", "need", "n_gated"):
        np.testing.assert_array_equal(N(getattr(trows, f)), np.asarray(getattr(jrows, f)), err_msg=f)
    assert int(N(trows.n_gated)) > jc.insert_row_cap

    sizes = np.asarray([0.5, 0.25, 0.125], np.float32)[N(trows.lvl)]
    vc = (N(trows.keys) + 0.5) * sizes[:, None]
    pr = N(trows.pidx)
    mom, moms = jv._pack_moments(j_pf.point_moments(jnp.asarray(q[pr] - vc), jnp.asarray(qv[pr])))
    jvm2 = jv.insert_packed_rows_hinted(jvm, jc, jrows, mom, moms)
    tvm2 = tv.insert_packed_rows_hinted(tvm, tc, trows, T(np.asarray(mom)), T(np.asarray(moms)))
    oc = N(tvm2.ocnt) - N(tvm.ocnt)
    assert oc[tv.OCNT_ROWCAP] > 0 and oc[tv.OCNT_REFIT] > 0
    assert_maps_match(jvm2, tvm2, jc.capacity)
    # The input map is left as it was (functional semantics).
    np.testing.assert_array_equal(N(tvm.ptab), np.asarray(jvm.ptab))


def test_gated_packed_insert_with_refit_kernel_matches_jax(rng):
    """insert_packed_rows_hinted with use_pallas_refit on, both sides (JAX
    on its refit kernel in interpret mode, the port on the plain version),
    over two inserts so refits of existing planes are included.  meta and
    mom to 1e-6 and planes to 5e-4 of their scale, as the JAX package's
    test_insert_points_pallas_refit_equivalent holds its own two paths."""
    jc, tc = cfgs(insert_row_cap=512, refit_budget=128, insert_rounds=2, use_pallas_refit=True)
    p, var, mask = scene(rng, 900)
    perm = rng.permutation(len(p))
    p, var, mask = p[perm], var[perm], mask[perm]
    jvm = jv.insert_points(jv.make_map(jc), jc, *(jnp.asarray(x) for x in (p[:300], var[:300], mask[:300])))
    tvm = tv.insert_points(tv.make_map(tc, "cpu"), tc, *(T(x) for x in (p[:300], var[:300], mask[:300])))
    np.testing.assert_array_equal(N(tvm.ptab), np.asarray(jvm.ptab))
    sizes_l = np.asarray([0.5, 0.25, 0.125], np.float32)
    for lo in (300, 600):
        q, qv, qm = p[lo:lo + 300], var[lo:lo + 300], mask[lo:lo + 300]
        m = jv.match_points(jvm, jc, jnp.asarray(q), jnp.asarray(qv), jnp.asarray(qm))
        own = [np.asarray(x) for x in (m.own_keys, m.own_slot, m.own_found, m.own_plane)]
        jrows = jv.gated_insert_rows(jc, jnp.asarray(qm), *(jnp.asarray(x) for x in own))
        trows = tv.gated_insert_rows(tc, T(qm), *(T(x) for x in own))
        vc = (N(trows.keys) + 0.5) * sizes_l[N(trows.lvl)][:, None]
        pr = N(trows.pidx)
        mom, moms = jv._pack_moments(j_pf.point_moments(jnp.asarray(q[pr] - vc), jnp.asarray(qv[pr])))
        jvm = jv.insert_packed_rows_hinted(jvm, jc, jrows, mom, moms)
        tvm = tv.insert_packed_rows_hinted(tvm, tc, trows, T(np.asarray(mom)), T(np.asarray(moms)))
        np.testing.assert_array_equal(N(tvm.ptab)[:, 0:4], np.asarray(jvm.ptab)[:, 0:4])
        np.testing.assert_allclose(N(tvm.meta), np.asarray(jvm.meta), atol=1e-6)
        np.testing.assert_allclose(N(tvm.mom), np.asarray(jvm.mom), atol=1e-6)
        pl_j = np.asarray(jvm.plane)
        # Normals only where the fit is well conditioned (lam_mid > 1e-3).
        loose = pl_j[:, 7] <= 1e-3
        scale = max(1.0, np.abs(pl_j[~loose]).max())
        np.testing.assert_allclose(N(tvm.plane)[~loose], pl_j[~loose], atol=5e-4 * scale)
        np.testing.assert_allclose(N(tvm.plane)[loose][:, [0, 1, 2, 6, 7, 8, 9]],
                                   pl_j[loose][:, [0, 1, 2, 6, 7, 8, 9]], atol=1e-5)
    assert N(tvm.meta)[:, 3].sum() > 10 and (~loose).sum() > 10
    assert_maps_match(jvm, tvm, jc.capacity)


@pytest.mark.parametrize("half,expect_drop", [(2, True), (100, False)])
def test_slide_map_matches_jax(rng, half, expect_drop):
    """slide_map clears the slots outside the box and keeps the rest, table
    for table and slot for slot as the JAX function; a box that holds the
    whole map changes nothing."""
    jc, tc = cfgs()
    p, var, mask = scene(rng)
    jvm = jv.insert_points(jv.make_map(jc), jc, *(jnp.asarray(x) for x in (p, var, mask)))
    tvm = to_port(jvm)
    pos = np.asarray([0.4, -0.3, 0.1], np.float32)
    js = jv.slide_map(jvm, jc, jnp.asarray(pos), half)
    ts = tv.slide_map(tvm, tc, T(pos), half)
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(N(a), np.asarray(b))
    dropped = int((N(tvm.ptab)[:, 3] > 0).sum() - (N(ts.ptab)[:, 3] > 0).sum())
    assert (dropped > 0) == expect_drop
    assert (N(ts.ptab)[:, 3] > 0).sum() > 0
