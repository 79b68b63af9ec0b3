"""The insert's claim rounds (``legkilo_torch/ops/claim_slots.py``) on the CPU.

``claim_call`` on CPU tensors is ``claim_plain`` and counts no launch.  The
CUDA kernel (csrc/claim_slots.cu) cannot run here, so its order of work is
rehearsed a row at a time in NumPy, every launch's rows in a shuffled
order as a card's threads may take them: the bid words zeroed once, each
round a probe-and-bid over the rows still unresolved (an atomic maximum of
the round-tagged row index on the first empty slot of the row's window),
then an award (the bidder whose bid stands writes its key), then a last
probe.  On the collision cases of tests/test_torch_voxel_map.py and the
cases the card tests take (duplicate keys, full windows, inactive rows, a
fleet's segments, 0 / 1 / 6 rounds, probe 1 and 8, no rows) the rehearsal
gives the plain version's table, slots and flags bit for bit.  The
kernel's hash primes are read from its source.
"""

import os
import re

import numpy as np
import pytest
import torch

from legkilo_torch.core import voxel_map as tv
from legkilo_torch.ops import claim_slots as cs
from legkilo_torch.ops import match_geom as mg

_PRIMES = (73856093, 471943, 83492791)


def rehearse(ptab_x, keys, seg, active, capacity, probe, rounds, rng):
    """The kernel's series (module doc) on NumPy copies; returns (ptab_x,
    slot, ok) as tensors."""
    tab = ptab_x.numpy().copy()
    keys, seg, active = keys.numpy(), seg.numpy(), active.numpy()
    S, M = tab.shape[0], keys.shape[0]
    miss, mask = S - 1, capacity - 1
    nseg = miss // capacity
    h = np.zeros(M, np.uint32)
    with np.errstate(over="ignore"):
        for i, p in enumerate(_PRIMES):
            h ^= keys[:, i].astype(np.uint32) * np.uint32(p)
    h0 = (h & np.uint32(mask)).astype(np.int64)
    bid = np.zeros(S, np.int64)                 # the memset
    slot = np.full(M, -7, np.int64)             # torch.empty: every row is written
    ok = np.zeros(M, bool)

    def probe_row(r):
        assert 0 <= seg[r] < nseg
        empty = -1
        for o in range(probe):
            idx = seg[r] * capacity + ((h0[r] + o) & mask)
            if tab[idx, 3] > 0:
                if (tab[idx, 0:3] == keys[r]).all():
                    return idx, empty
            elif empty < 0:
                empty = idx
        return -1, empty

    def probe_launch(k, bidding, first):
        for r in rng.permutation(M):
            if not active[r]:
                if first:
                    slot[r], ok[r] = miss, False
                continue
            if not first and ok[r]:
                continue
            found, empty = probe_row(r)
            if found >= 0:
                slot[r], ok[r] = found, True
                continue
            if first:
                ok[r] = False
            if bidding and empty >= 0:
                slot[r] = empty
                bid[empty] = max(bid[empty], k * M + r + 1)
            else:
                slot[r] = miss

    def award(k):
        for r in rng.permutation(M):
            if not active[r] or ok[r]:
                continue
            c = slot[r]
            if c == miss or bid[c] != k * M + r + 1:
                continue
            tab[c] = [*keys[r], 1, 0]

    for k in range(rounds):
        probe_launch(k, True, k == 0)
        award(k)
    probe_launch(rounds, False, rounds == 0)
    return torch.from_numpy(tab), torch.from_numpy(slot), torch.from_numpy(ok)


def keys_on(h, capacity, n, lo=-8, hi=8):
    """Up to n distinct keys whose hash is h."""
    cand = np.stack(np.meshgrid(*[np.arange(lo, hi)] * 3, indexing="ij"), -1).reshape(-1, 3)
    got = mg.hash_keys(*(torch.from_numpy(cand[:, i].astype(np.int32)) for i in range(3)), capacity)
    return cand[got.numpy() == h][:n].astype(np.int32)


def table(n_seg, capacity, rng, fill=0.0):
    """A sentinel-extended probe table with a share ``fill`` of its slots
    occupied by random keys (some of them planes)."""
    tab = np.zeros((n_seg * capacity + 1, 5), np.int32)
    occ = rng.random(n_seg * capacity) < fill
    tab[:-1][occ, 0:3] = rng.integers(-20, 20, size=(occ.sum(), 3))
    tab[:-1][occ, 3] = 1
    tab[:-1][occ, 4] = rng.random(occ.sum()) < 0.3
    return torch.from_numpy(tab)


def scene_rows(rng, n=600, levels=3, voxel=0.5):
    """tests/test_torch_voxel_map.py's scene as insert_points keys it:
    (keys [L*n, 3], segments [L*n], mask [L*n])."""
    pts = []
    for normal, off in (((0, 0, 1), 0.1), ((1, 0, 0), 1.3), ((0, 1, 0), -1.2)):
        m = n // 4
        uv = rng.uniform(-1, 1, size=(m, 3))
        uv[:, np.argmax(normal)] = off + rng.normal(scale=0.003, size=m)
        pts.append(uv)
    pts.append(rng.uniform(-2, 2, size=(n - 3 * (n // 4), 3)))
    p = torch.from_numpy(np.concatenate(pts).astype(np.float32))
    keys = torch.cat([tv.voxel_key(p, voxel / 2 ** l) for l in range(levels)])
    seg = torch.arange(levels, dtype=torch.int64).repeat_interleave(len(p))
    mask = torch.from_numpy(rng.random(len(p)) < 0.9).repeat(levels)
    return keys, seg, mask


def case(name, rng):
    """(ptab_x, keys, seg, active, capacity, probe, rounds) of a named case."""
    if name == "one_slot_windows":  # test_duplicate_claims_last_writer_wins: 4 keys on slot 3, 3 on 9
        keys = np.concatenate([keys_on(3, 16, 4), keys_on(9, 16, 3)])
        m = len(keys)
        return table(1, 16, rng), torch.from_numpy(keys), torch.zeros(m, dtype=torch.int64), \
            torch.ones(m, dtype=torch.bool), 16, 1, 1
    if name == "full_windows":  # 12 distinct keys starting on one slot, windows of 4: 8 fail
        keys = keys_on(5, 16, 12)
        m = len(keys)
        return table(1, 16, rng), torch.from_numpy(keys), torch.zeros(m, dtype=torch.int64), \
            torch.ones(m, dtype=torch.bool), 16, 4, 6
    if name == "duplicates":  # three keys, each in many rows, beside distinct ones
        keys = rng.integers(-4, 4, size=(300, 3)).astype(np.int32)
        keys[::3] = [1, 2, 3]
        keys[1::7] = [-1, 0, 2]
        keys[2::11] = [3, 3, -4]
        m = len(keys)
        return table(2, 64, rng, 0.2), torch.from_numpy(keys), \
            torch.from_numpy(rng.integers(0, 2, size=m)), torch.ones(m, dtype=torch.bool), 64, 8, 6
    if name == "scene":  # the voxel map tests' scene: 3 levels of 256 slots, windows of 4
        keys, seg, mask = scene_rows(rng)
        return table(3, 256, rng, 0.1), keys, seg, mask, 256, 4, 2
    if name == "fleet":  # two replicas' maps viewed flat: segment r*L + level, half of the rows inactive
        keys, seg, mask = scene_rows(rng, 400)
        keys = torch.cat([keys, keys + 1])
        seg = torch.cat([seg, seg + 3])
        active = torch.from_numpy(rng.random(len(keys)) < 0.5)
        return table(6, 128, rng, 0.3), keys, seg, active, 128, 8, 6
    raise KeyError(name)


CASES = ["one_slot_windows", "full_windows", "duplicates", "scene", "fleet"]


@pytest.mark.parametrize("name", CASES)
def test_claim_call_on_cpu_is_the_plain_version(name):
    rng = np.random.default_rng(1)
    ptab_x, keys, seg, active, c, p, r = case(name, rng)
    n0 = cs.claim_call.launches
    t_call, t_plain = ptab_x.clone(), ptab_x.clone()
    got = cs.claim_call(t_call, keys, seg, active, c, p, r)
    want = cs.claim_plain(t_plain, keys, seg, active, c, p, r)
    assert cs.claim_call.launches == n0
    assert torch.equal(t_call, t_plain)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("name", CASES)
def test_kernel_order_of_work_gives_the_plain_result(name):
    """The rehearsal, in three shuffled thread orders, against claim_plain:
    the table but its sentinel row, slots and flags bit for bit."""
    rng = np.random.default_rng(2)
    ptab_x, keys, seg, active, c, p, r = case(name, rng)
    miss = ptab_x.shape[0] - 1
    want_tab = ptab_x.clone()
    want_slot, want_ok = cs.claim_plain(want_tab, keys, seg, active, c, p, r)
    for order_seed in range(3):
        tab, slot, ok = rehearse(ptab_x, keys, seg, active, c, p, r, np.random.default_rng(order_seed))
        assert torch.equal(tab[:miss], want_tab[:miss])
        assert torch.equal(slot, want_slot) and torch.equal(ok, want_ok)
    if name == "one_slot_windows":  # the last of each slot's claimants wins, 5 claims fail
        assert int((active & ~want_ok).sum()) == 5
        assert want_tab[3, 0:3].tolist() == keys[3].tolist()
    if name == "full_windows":
        assert int((active & ~want_ok).sum()) == 8
    if name == "duplicates":
        first = int(np.flatnonzero((keys.numpy() == [1, 2, 3]).all(1))[0])
        same = (keys == keys[first]).all(1) & (seg == seg[first])
        assert bool(want_ok[same].all()) and len(set(want_slot[same].tolist())) == 1


@pytest.mark.parametrize("rounds", [0, 1, 6])
@pytest.mark.parametrize("probe", [1, 8])
def test_rehearsal_at_each_rounds_and_probe(rounds, probe):
    """A crowded fleet table (half full, 64 slots a segment) with inactive
    rows and repeated keys, at 0, 1 and 6 rounds and windows of 1 and 8."""
    rng = np.random.default_rng(3)
    ptab_x = table(4, 64, rng, 0.5)
    keys = torch.from_numpy(rng.integers(-6, 6, size=(500, 3)).astype(np.int32))
    seg = torch.from_numpy(rng.integers(0, 4, size=500))
    active = torch.from_numpy(rng.random(500) < 0.8)
    miss = ptab_x.shape[0] - 1
    want_tab = ptab_x.clone()
    want_slot, want_ok = cs.claim_plain(want_tab, keys, seg, active, 64, probe, rounds)
    tab, slot, ok = rehearse(ptab_x, keys, seg, active, 64, probe, rounds, rng)
    assert torch.equal(tab[:miss], want_tab[:miss])
    assert torch.equal(slot, want_slot) and torch.equal(ok, want_ok)
    assert bool((slot[~active] == miss).all()) and not bool(ok[~active].any())
    if rounds == 0:
        assert torch.equal(want_tab, ptab_x)


def test_no_rows():
    ptab_x = table(1, 16, np.random.default_rng(4), 0.5)
    empty = (torch.zeros((0, 3), dtype=torch.int32), torch.zeros(0, dtype=torch.int64),
             torch.zeros(0, dtype=torch.bool))
    tab = ptab_x.clone()
    slot, ok = cs.claim_call(tab, *empty, 16, 8, 6)
    assert slot.shape == ok.shape == (0,) and torch.equal(tab, ptab_x)
    got = rehearse(ptab_x, *empty, 16, 8, 6, np.random.default_rng(0))
    assert torch.equal(got[0], ptab_x) and got[1].shape == (0,)


def test_kernel_hashes_with_the_keys_kernels_primes():
    """The claim kernel's primes are keys_kernel's and hash_keys's, in order."""
    src_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "legkilo_torch", "csrc")

    def primes(name):
        with open(os.path.join(src_dir, name)) as fh:
            text = fh.read()
        return tuple(int(x) for x in re.search(r"prime\[3\] = \{(\d+)u, (\d+)u, (\d+)u\}", text).groups())

    assert primes("claim_slots.cu") == primes("match_geom.cu") == mg._HASH_P == _PRIMES


def test_find_or_insert_routes_through_claim_call(monkeypatch):
    """voxel_map's claims go through claim_call, with the map's capacity,
    probe and rounds."""
    seen = []

    def spy(*args):
        seen.append(args[4:])
        return cs.claim_call(*args)

    monkeypatch.setattr(tv, "claim_call", spy)
    cfg = tv.MapConfig(levels=3, capacity=256, probe=4, voxel_size=0.5, planer_threshold=0.01,
                       sigma_num=3.0, max_points_num=50, init_num=(5, 5, 5), insert_rounds=2)
    rng = np.random.default_rng(5)
    p = torch.from_numpy(rng.uniform(-2, 2, size=(200, 3)).astype(np.float32))
    var = torch.eye(3).expand(200, 3, 3) * 1e-4
    vm = tv.insert_points(tv.make_map(cfg, "cpu"), cfg, p, var, torch.ones(200, dtype=torch.bool))
    assert seen == [(256, 4, 2)]
    assert int((vm.ptab[:, 3] > 0).sum()) > 200
