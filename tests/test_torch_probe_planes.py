"""The fused match's probe and plane gather (``legkilo_torch/ops/probe_planes.py``) on the CPU.

``probe_planes_call`` on CPU tensors is ``probe_planes_plain``, the eager
glue the CUDA kernel (csrc/probe_planes.cu) replaced, and counts no launch.
The plain version is held against

* the JAX package's XLA probe (legkilo_tpu/core/filter_deferred.py:390-424,
  written out below as that function runs it inline) on the CPU, every
  output exactly;
* ``claim_slots.probe_plain``, the insert's lookup: slot, found and
  is_plane of every candidate;

on fleet tables of 1 and 3 replicas at 1 and 3 levels, windows of 1 and 8,
f32, f16 and bf16 plane storage, and on rows built for the edges: a window
that wraps past C - 1, a key at offset probe - 1, a key past an empty slot,
the same key twice in one window, key words on an empty slot, a key just
beyond the window.  The fused match itself (``_match_compact_stats_kernel``)
gives the pre-change glue's s40, counts and aux bit for bit over two fleet
steps, IMU and kin.  The file imports JAX only inside the test that
compares with it, so tests/test_torch_cuda.py takes its cases on the card.
"""

import functools

import numpy as np
import pytest
import torch

from legkilo_torch.core import filter_deferred as t_fd
from legkilo_torch.core.voxel_map import _gather_fill
from legkilo_torch.ops import claim_slots as cs
from legkilo_torch.ops import match_geom as mg
from legkilo_torch.ops import probe_planes as pp
from legkilo_torch.parallel import sweep as t_sw
from test_torch_fleet import distinct_start, small_cfg
from test_torch_insert_in_place import _kin_yaml
from torch_util import one_thread  # noqa: F401


def hash0(keys, capacity):
    """The keys kernel's hash of int32 keys [M, 3] (int64 numpy)."""
    cols = [torch.from_numpy(np.ascontiguousarray(keys[:, i])) for i in range(3)]
    return mg.hash_keys(*cols, capacity).numpy().astype(np.int64)


def plane_table(rng, S, storage):
    """[S, 31] random plane rows in the storage dtype, none of them zero."""
    return torch.from_numpy(rng.normal(size=(S, 31)).astype(np.float32) + 0.01).to(storage)


def rows_of(keys, seg, capacity, n_cand):
    """keys_t [6L, R] and idx0_t [2L, R] from a [2L * R, 3] block of keys and
    their segments, candidate-major (candidate j's rows j*R ... j*R + R - 1)."""
    R = keys.shape[0] // n_cand
    idx0 = seg * capacity + hash0(keys, capacity)
    keys_t = keys.reshape(n_cand, R, 3).transpose(0, 2, 1).reshape(3 * n_cand, R)
    return (torch.from_numpy(np.ascontiguousarray(keys_t)),
            torch.from_numpy(idx0.reshape(n_cand, R).astype(np.int32)))


def fleet_case(rng, b, levels, capacity, probe, rows, storage, fill=0.4):
    """A fleet's flat map of ``b`` replicas (segment r * L + level), each
    segment filled as the insert fills it (a key in the first empty slot of
    its window, dropped when the window is full), key words left on a share
    of the empty slots; ``rows`` rows a replica whose 2L candidates hold a
    key of their own segment (60 %) or a random one (mostly misses)."""
    n_seg = b * levels
    S = n_seg * capacity
    ptab = np.zeros((S, 5), np.int32)
    held = []
    for sg in range(n_seg):
        keys = np.unique(rng.integers(-30, 30, size=(int(fill * capacity), 3)).astype(np.int32), axis=0)
        h = hash0(keys, capacity)
        mine = []
        for k, h0 in zip(keys, h):
            for o in range(probe):
                s = sg * capacity + ((h0 + o) & (capacity - 1))
                if ptab[s, 3] == 0:
                    ptab[s] = [*k, 1, int(rng.random() < 0.4)]
                    mine.append(k)
                    break
        held.append(np.array(mine, np.int32).reshape(-1, 3))
    stale = (ptab[:, 3] == 0) & (rng.random(S) < 0.2)
    ptab[stale, 0:3] = rng.integers(-30, 30, size=(int(stale.sum()), 3))
    n_cand = 2 * levels
    keys = np.zeros((n_cand, b * rows, 3), np.int32)
    seg = np.zeros((n_cand, b * rows), np.int64)
    for j in range(n_cand):
        for r in range(b):
            sg = r * levels + j % levels
            pick = held[sg][rng.integers(0, len(held[sg]), size=rows)]
            own = rng.random(rows) < 0.6
            keys[j, r * rows:(r + 1) * rows] = np.where(own[:, None], pick,
                                                        rng.integers(-30, 30, size=(rows, 3)))
            seg[j, r * rows:(r + 1) * rows] = sg
    keys_t, idx0_t = rows_of(keys.reshape(-1, 3), seg.reshape(-1), capacity, n_cand)
    return torch.from_numpy(ptab), plane_table(rng, S, storage), keys_t, idx0_t, capacity, probe


# Rows built for the edges, each in a segment of its own (C = 64): where
# its key sits (offset, is_plane, occupied), beside other keys' entries.
EDGES = {
    "wrap": [(5, 1, 1)],                        # the start is one of the last three slots
    "last_offset": [(7, 0, 1)],
    "past_empty": [(3, 1, 1)],                  # offsets 0-2 empty
    "twice_plane_first": [(1, 1, 1), (5, 0, 1)],
    "twice_plane_second": [(2, 0, 1), (6, 1, 1)],
    "words_on_empty": [(0, 1, 0), (2, 0, 1)],   # the key's words at offset 0, not occupied
    "beyond_window": [(8, 1, 1)],
    "first_offset": [(0, 0, 1)],
}
EDGE_C = 64


def edge_case(rng, probe, storage):
    """(ptab, plane, keys_t, idx0_t, capacity, probe) of the EDGES rows at
    L = 1 (the first half of them the own chain's candidates, the rest the
    neighbour's), and each row's (offset, is_plane) or None for a miss."""
    names = list(EDGES)
    pool = np.unique(rng.integers(-1000, 1000, size=(6000, 3)).astype(np.int32), axis=0)
    h = hash0(pool, EDGE_C)
    wraps, plain = pool[h >= EDGE_C - 3], pool[h < EDGE_C - 16]
    S = len(names) * EDGE_C
    ptab = np.zeros((S, 5), np.int32)
    keys, want = [], []
    for t, name in enumerate(names):
        k = wraps[0] if name == "wrap" else plain[t]
        h0 = hash0(k[None], EDGE_C)[0]
        base = t * EDGE_C
        put = EDGES[name]
        taken = {o for o, _, _ in put}
        for o in range(10):  # other keys around it, but where a row needs an empty slot
            if o not in taken and not (name == "past_empty" and o < 3):
                ptab[base + ((h0 + o) & (EDGE_C - 1))] = [k[0] + 1, k[1], k[2], 1, o % 2]
        for o, isp, occ in put:
            ptab[base + ((h0 + o) & (EDGE_C - 1))] = [*k, occ, isp]
        keys.append(k)
        hits = [(o, isp) for o, isp, occ in put if occ and o < probe]
        want.append(min(hits) if hits else None)
    keys_t, idx0_t = rows_of(np.array(keys), np.arange(len(names)), EDGE_C, 2)
    return (torch.from_numpy(ptab), plane_table(rng, S, storage), keys_t, idx0_t, EDGE_C, probe), want


CASES = {
    "b1_l1_p8": lambda rng: fleet_case(rng, 1, 1, 64, 8, 40, torch.float32),
    "b3_l3_p8": lambda rng: fleet_case(rng, 3, 3, 64, 8, 50, torch.float32),
    "b3_l3_p1": lambda rng: fleet_case(rng, 3, 3, 64, 1, 50, torch.float32),
    "b1_l3_p8_f16": lambda rng: fleet_case(rng, 1, 3, 128, 8, 60, torch.float16),
    "b3_l1_p8_bf16": lambda rng: fleet_case(rng, 3, 1, 64, 8, 50, torch.bfloat16),
    "edges_p8": lambda rng: edge_case(rng, 8, torch.float32)[0],
    "edges_p1": lambda rng: edge_case(rng, 1, torch.float32)[0],
    "edges_p8_bf16": lambda rng: edge_case(rng, 8, torch.bfloat16)[0],
}


def jax_probe_glue(ptab, plane, keys_t, idx0_t, C, probe, dtype):
    """The JAX package's probe glue (legkilo_tpu/core/filter_deferred.py:396-424),
    as ``_match_compact_stats_pallas`` runs it on the flat map."""
    import jax.numpy as jnp

    L2, cap = idx0_t.shape
    L, miss = L2 // 2, ptab.shape[0]
    offs = jnp.arange(probe, dtype=jnp.int32)
    h0 = idx0_t & (C - 1)
    base = idx0_t - h0
    idx = base[:, :, None] + ((h0[:, :, None] + offs[None, None, :]) & (C - 1))
    k_at = ptab.reshape(miss, 5)[idx]
    keys_cmp = keys_t.reshape(2 * L, 3, cap).transpose(0, 2, 1)
    match = (k_at[..., 3] > 0) & jnp.all(k_at[..., 0:3] == keys_cmp[:, :, None, :], axis=-1)
    big = 2 * probe
    isp_at = (k_at[..., 4] > 0).astype(jnp.int32)
    score = jnp.where(match, 2 * offs[None, None, :] + isp_at, big)
    msel = jnp.min(score, axis=-1)
    found = msel < big
    slot = jnp.where(found, base + ((h0 + (msel >> 1)) & (C - 1)), miss)
    isp = ((msel & 1) == 1) & found
    plane_at = plane.reshape(miss, -1).at[slot].get(mode="fill", fill_value=0.0).astype(dtype)
    plane_t = plane_at.transpose(0, 2, 1).reshape(2 * L * 31, cap)
    flags_t = jnp.concatenate([found.astype(dtype), isp.astype(dtype)], axis=0)
    return plane_t, flags_t, slot[0:L], found[0:L], isp[0:L]


@functools.lru_cache(maxsize=None)
def _jax_glue():
    import jax

    return jax.jit(jax_probe_glue, static_argnums=(4, 5, 6))


def assert_outputs_equal(got, want):
    names = ("plane_t", "flags_t", "slot", "found", "isp")
    for name, a, b in zip(names, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, (name, a.dtype, b.dtype, a.shape, b.shape)
        assert torch.equal(a, b), name


@pytest.mark.parametrize("name", list(CASES))
def test_call_on_cpu_is_the_plain_version(name):
    args = CASES[name](np.random.default_rng(1))
    n0 = pp.probe_planes_call.launches
    got = pp.probe_planes_call(*args, torch.float32)
    assert pp.probe_planes_call.launches == n0
    assert_outputs_equal(got, pp.probe_planes_plain(*args, torch.float32))


@pytest.mark.parametrize("name", list(CASES))
def test_plain_version_is_the_jax_glue(name):
    import jax.numpy as jnp

    ptab, plane, keys_t, idx0_t, C, probe = CASES[name](np.random.default_rng(2))
    got = pp.probe_planes_plain(ptab, plane, keys_t, idx0_t, C, probe, torch.float32)
    storage = {torch.float32: jnp.float32, torch.float16: jnp.float16, torch.bfloat16: jnp.bfloat16}
    want = _jax_glue()(jnp.asarray(ptab.numpy()), jnp.asarray(plane.float().numpy()).astype(storage[plane.dtype]),
                       jnp.asarray(keys_t.numpy()), jnp.asarray(idx0_t.numpy()), C, probe, jnp.float32)
    for name_, a, b in zip(("plane_t", "flags_t", "slot", "found", "isp"), got, want):
        b = np.asarray(b)
        assert a.shape == b.shape and np.array_equal(a.numpy(), b.astype(a.numpy().dtype)), name_
    assert got[2].dtype == torch.int64 and got[3].dtype == got[4].dtype == torch.bool


@pytest.mark.parametrize("name", list(CASES))
def test_plain_version_finds_what_the_inserts_lookup_finds(name):
    """Every candidate's slot, found and is_plane are claim_slots.probe_plain's
    for its key in its segment; a miss reads 31 zeros, a hit its slot's row."""
    ptab, plane, keys_t, idx0_t, C, probe = CASES[name](np.random.default_rng(3))
    plane_t, flags_t, slot, found, isp = pp.probe_planes_plain(ptab, plane, keys_t, idx0_t, C, probe,
                                                               torch.float32)
    L2, R = idx0_t.shape
    miss = ptab.shape[0]
    for j in range(L2):
        keys = keys_t[3 * j:3 * j + 3].T.contiguous()
        seg = idx0_t[j].to(torch.int64) // C
        s, f, _, _, i = cs.probe_plain(ptab, keys, seg, C, probe, miss)
        assert torch.equal(flags_t[j], f.float()) and torch.equal(flags_t[L2 + j], i.float())
        if j < L2 // 2:
            assert torch.equal(slot[j], s) and torch.equal(found[j], f) and torch.equal(isp[j], i)
        rows = plane_t[31 * j:31 * (j + 1)].T
        assert torch.equal(rows[f], plane[s[f]].float())
        assert not bool(rows[~f].any())
    assert 0 < int(flags_t[:L2].sum()) < L2 * R  # hits and misses


@pytest.mark.parametrize("probe", [1, 8])
def test_edge_rows_find_the_lowest_matching_offset(probe):
    """Each edge row's own expectation: the lowest occupied matching offset
    inside the window, its is_plane, and misses past the window or on words
    with no occupied flag."""
    (ptab, plane, keys_t, idx0_t, C, _), want = edge_case(np.random.default_rng(5), probe, torch.float32)
    plane_t, flags_t, slot, found, isp = pp.probe_planes_plain(ptab, plane, keys_t, idx0_t, C, probe,
                                                               torch.float32)
    L2, R = idx0_t.shape
    idx0 = idx0_t.to(torch.int64)
    for t, w in enumerate(want):
        j, r = divmod(t, R)
        assert bool(flags_t[j, r]) == (w is not None), (list(EDGES)[t], probe)
        if w is None:
            continue
        o, is_plane = w
        h0 = int(idx0[j, r]) & (C - 1)
        s = int(idx0[j, r]) - h0 + ((h0 + o) & (C - 1))
        assert bool(flags_t[L2 + j, r]) == bool(is_plane), list(EDGES)[t]
        assert torch.equal(plane_t[31 * j:31 * (j + 1), r], plane[s].float())
        if j == 0:
            assert int(slot[0, r]) == s and bool(found[0, r]) and bool(isp[0, r]) == bool(is_plane)
    if probe == 8:  # the window wrapped: the slot lies below the start
        r = list(EDGES).index("wrap")
        assert int(slot[0, r]) < int(idx0[0, r])


def test_no_rows():
    ptab, plane, keys_t, idx0_t, C, probe = CASES["b1_l1_p8"](np.random.default_rng(6))
    got = pp.probe_planes_call(ptab, plane, keys_t[:, :0], idx0_t[:, :0], C, probe, torch.float32)
    assert [tuple(x.shape) for x in got] == [(62, 0), (4, 0), (1, 0), (1, 0), (1, 0)]


def _pre_change_glue(ptab, plane, keys_t, idx0_t, C, probe, dtype):
    """``_match_compact_stats_kernel``'s probe before the kernel took it
    (legkilo_torch/core/filter_deferred.py, the glue between keys_call and
    select_call), on its own inputs."""
    L2, R = idx0_t.shape
    L, miss, dev = L2 // 2, ptab.shape[0], idx0_t.device
    offs = torch.arange(probe, dtype=torch.int64, device=dev)
    idx0 = idx0_t.to(torch.int64)
    h0 = idx0 & (C - 1)
    base = idx0 - h0
    idx = base[:, :, None] + ((h0[:, :, None] + offs) & (C - 1))
    k_at = ptab.reshape(miss, -1)[idx]
    keys_cmp = keys_t.reshape(2 * L, 3, R).permute(0, 2, 1)
    match = (k_at[..., 3] > 0) & torch.all(k_at[..., 0:3] == keys_cmp[:, :, None, :], dim=-1)
    big = 2 * probe
    score = torch.where(match, 2 * offs + (k_at[..., 4] > 0).to(torch.int64), big)
    msel = torch.min(score, dim=-1).values
    found = msel < big
    slot = torch.where(found, base + ((h0 + (msel >> 1)) & (C - 1)), miss)
    isp = ((msel & 1) == 1) & found
    plane_at = _gather_fill(plane.reshape(miss, -1), slot, 0.0).to(dtype)
    plane_t = plane_at.permute(0, 2, 1).reshape(2 * L * 31, R).contiguous()
    flags_t = torch.cat([found.to(dtype), isp.to(dtype)], dim=0)
    return plane_t, flags_t, slot[0:L], found[0:L], isp[0:L]


@pytest.mark.parametrize("route", ["imu", "kin"])
def test_fused_match_is_the_pre_change_glue(route, monkeypatch):
    """Two fleet steps of 2 distinct replicas on the fused path (bench-like
    small maps; kin: configs/leg_fusion.yaml at NB 64, K 4): each match
    pass's s40, match counts and aux ``torch.equal`` to the same pass with
    the pre-change glue in the probe's place."""
    cfg = small_cfg() if route == "imu" else _kin_yaml()
    scfg, carry, params, seqs = distinct_start(cfg, 2, duration=0.5)
    real_match = t_fd._match_compact_stats_kernel
    passes = []

    def both(*args):
        got = real_match(*args)
        with monkeypatch.context() as m:
            m.setattr(t_fd, "probe_planes_call", _pre_change_glue)
            want = real_match(*args)
        passes.append(int(got[1].sum()))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert len(got[2]) == len(want[2]) == 9
        for a, b in zip(got[2], want[2]):
            assert a.dtype == b.dtype and torch.equal(a, b)
        return got

    monkeypatch.setattr(t_fd, "_match_compact_stats_kernel", both)
    step = t_sw.make_fleet_step(scfg)
    for pk in t_sw.stack_packets(seqs)[:2]:
        carry, _, _ = step(carry, pk, params)
    assert len(passes) >= 2 and all(n > 0 for n in passes), passes

