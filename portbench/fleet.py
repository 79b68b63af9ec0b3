"""The system under test: ``legkilo_torch``'s Monte-Carlo fleet, driven as
``python -m legkilo_torch sweep`` drives it in broadcast mode.

Set-up builds the host packets of one simulated sequence once, and
initialises the fleet.  The measured window then runs trials back to back:
a trial initialises the fleet (``fleet_init`` from the first packet, the
state copied to B replicas, each replica's ``q_diag`` jittered by
``perturb_params`` with the trial's seed) and steps it through the whole
sequence.  Each call uploads and broadcasts its packets (``to_device_packet``,
``broadcast_packets``), runs one fleet step (``make_fleet_step``) or a chunk
of them (``make_fleet_chunk_step``), and reads every replica's poses and
match counts back before the next call is sent: a closed loop.

The benchmark's own spans (perf_counter, tied once a window to the wall
clock that the profiler's trace uses) mark what the host does:
``pb.upload``, ``pb.step``, ``pb.readback``, ``pb.reinit`` and
``pb.snapshot``.  Before and after the calls that the check samples
(``draw_samples``: calls of the first trial, and calls of the last later
trial to reach them), the sampled replicas' states and maps are copied to
the host (``pb.snapshot``), so that the reference can follow them after
the window has closed.
"""

from __future__ import annotations

import time
from typing import Dict, List, NamedTuple

import numpy as np



def trial_seed(seed: int, trial: int) -> int:
    """The jitter seed of a trial: distinct for every (run seed, trial)."""
    return (int(seed) * 1_000_003 + 7_919 * int(trial) + 1) % (1 << 62)


def host_packets(builder, cfg, scans, events) -> list:
    """The packetizer ``builder`` fed as ``sweep`` feeds it: each scan after
    the events up to 0.5 s past its end, in time order."""
    add = builder.add_imu if cfg.only_imu_use else builder.add_kin_imu
    evs = sorted(events, key=lambda e: e.time)
    out, j = [], 0
    for scan in scans:
        while j < len(evs) and evs[j].time <= scan.end_time + 0.5:
            add(evs[j])
            j += 1
        builder.add_scan(scan)
        while builder.ready():
            out.append(builder.pop())
    return out


class Sample(NamedTuple):
    """A call the check follows: ``tag`` 0 is the window's first trial, 1
    the last trial of the window to reach the call; ``trial`` is the trial
    it was read in (set after the window for tag 1)."""

    tag: int
    call: int
    replicas: tuple
    trial: int = 0


def draw_samples(seed: int, n_calls: int, n_sampled: int, batch: int) -> List[Sample]:
    """The calls and replicas that the check compares, drawn from the seed:
    in the first trial, its first call (the start), its last (the map at
    the end of a trial) and calls between, each with one replica from each
    half of the fleet; in a later trial (with another jitter and the fleet
    initialised again), its first call and one other, one replica each."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 0x5A])
    calls = {0, n_calls - 1}
    while len(calls) < min(n_sampled, n_calls):
        calls.add(int(rng.integers(1, n_calls - 1)))
    half = max(batch // 2, 1)
    out = []
    for c in sorted(calls):
        reps = (int(rng.integers(0, half)),)
        if batch > 1:
            reps += (int(rng.integers(half, batch)),)
        out.append(Sample(0, c, reps))
    later = sorted({0, int(rng.integers(1, n_calls))} if n_calls > 1 else {0})
    out += [Sample(1, c, (int(rng.integers(0, batch)),)) for c in later]
    return out


class Window(NamedTuple):
    """What the measured window did, read by the metrics and the check."""

    seconds: float                 # first dispatch to the last read-back
    calls: int
    scans_per_call: int
    replica_scans: int
    call_ms: List[float]           # each call: dispatch (upload) to read-back
    spans: List[tuple]             # (name, t0, t1) perf_counter seconds
    clock0: tuple                  # (perf_counter s, time.time_ns()) read together
    readback: Dict[tuple, tuple]   # (tag, call) -> (pos [B, S, 3], n_matched [B, S])
    non_finite: int                # replica-scans with a non-finite pose
    snapshots: Dict[tuple, list]   # (tag, call, "before"|"after") -> a dict a replica
    trials: int
    trial_of: Dict[tuple, int]     # (tag, call) -> the trial it was read in


class Fleet:
    """The fleet of one cell on ``device``: ``traffic`` gives the replicas,
    the scans a call and the jitter; ``settings`` the flat YAML keys."""

    def __init__(self, settings: dict, traffic: dict, sim_data, seed: int, device="cuda"):
        import torch

        from legkilo_torch.config import from_dict
        from legkilo_torch.core.filter_fleet import replica, tree_map
        from legkilo_torch.io.dataset import PacketBuilder, decimate_blind, to_device_packet
        from legkilo_torch.parallel import sweep
        from legkilo_torch.runner import make_params, make_static_config

        self.torch, self.sweep, self.tree_map, self.replica = torch, sweep, tree_map, replica
        self.to_device_packet = to_device_packet
        self.device = torch.device(device)
        self.seed = int(seed)
        self.batch = int(traffic["replicas"])
        self.chunk = int(traffic["scans_per_call"])
        self.noise = float(traffic["noise_scale"])
        self.cfg = cfg = from_dict(settings)
        self.scfg = make_static_config(cfg)
        events = sim_data.imu if cfg.only_imu_use else sim_data.kin
        pkts = host_packets(PacketBuilder(cfg), cfg, sim_data.scans, events)
        first = pkts[0]
        m = first.imu_mask
        self.first = (first.imu_acc[m].mean(axis=0), first.imu_gyr[m].mean(axis=0),
                      float(first.end_offset))
        self.first_points = decimate_blind(sim_data.scans[0].points, sim_data.scans[0].time_offset,
                                           cfg.lidar.filter_num, cfg.lidar.blind)[0]
        n_calls = (len(pkts) - 1) // self.chunk
        self.calls_host = [pkts[1 + i * self.chunk: 1 + (i + 1) * self.chunk] for i in range(n_calls)]
        self.params0 = make_params(cfg, self.device)
        if self.chunk > 1:
            self.step = sweep.make_fleet_chunk_step(self.scfg)
        else:
            self.step = sweep.make_fleet_step(self.scfg)

    @property
    def calls_per_trial(self) -> int:
        return len(self.calls_host)

    def init_trial(self, trial: int):
        """``fleet_init`` of the first packet, copied to B replicas, q_diag
        jittered with the trial's seed; returns (carry, params)."""
        acc, gyr, off = self.first
        one, params1 = self.sweep.fleet_init(
            self.scfg, self.params0, [self.first_points], acc[None], gyr[None], np.asarray([off]),
            float(self.cfg.gravity), device=self.device)
        b = self.batch
        carry = self.tree_map(lambda x: x.expand((b,) + tuple(x.shape[1:])).clone(), one)
        params = self.sweep.perturb_params(self.replica(params1, 0), b, scale=self.noise,
                                           seed=trial_seed(self.seed, trial))
        return carry, params

    def upload(self, call: int):
        """The call's packets on the card, broadcast to every replica (and
        stacked along the scan axis for a chunked call)."""
        devs = [self.sweep.broadcast_packets(self.to_device_packet(p, self.device), self.batch)
                for p in self.calls_host[call]]
        if self.chunk > 1:
            return self.sweep.stack_fleet_chunks(devs, self.chunk)[0]
        return devs[0]

    def call(self, carry, params, dev):
        carry, out, _ = self.step(carry, dev, params)
        return carry, out

    def read_back(self, out):
        pos, nm = out.pos.cpu().numpy(), out.n_matched.cpu().numpy()
        if self.chunk == 1:
            pos, nm = pos[:, None], nm[:, None]
        return pos, nm

    def snapshot(self, carry, replicas) -> list:
        """The replicas' states and maps, copied to the host: the map as its
        occupied slots and their rows (``slot`` within the replica's
        tables).  Taken after a read-back, when the card has no work
        queued."""
        torch, out = self.torch, []
        vm = carry.vm
        for r in replicas:
            slot = torch.nonzero(vm.ptab[r, :, 3] > 0)[:, 0]
            d = dict(rot=carry.state.rot[r], lin=carry.state.lin[r], cov=carry.cov[r],
                     lp=carry.last_predict_t[r], lu=carry.last_update_t[r], slot=slot,
                     ptab=vm.ptab[r, slot], meta=vm.meta[r, slot], mom=vm.mom[r, slot],
                     moms=vm.moms[r, slot].float(), plane=vm.plane[r, slot].float(),
                     ocnt=vm.ocnt[r])
            out.append({k: v.cpu().numpy() for k, v in d.items()})
        return out

    def warm_up(self, calls: int = 2):
        """The cell's own shapes once: a trial's initialisation and its
        first ``calls`` calls, read back."""
        carry, params = self.init_trial(-1)
        for c in range(min(calls, self.calls_per_trial)):
            carry, out = self.call(carry, params, self.upload(c))
            self.read_back(out)
        self.snapshot(carry, (0,))
        del carry, params, out
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()

    def run_window(self, seconds: float, samples: List[Sample]) -> Window:
        """Trials back to back until ``seconds`` have passed: the last call
        started before then is finished and read back, and counted.  The
        window runs at least its first trial and each later-trial sample's
        call once; the sampled calls' carries are copied before and after
        (``snapshot``)."""
        spans: List[tuple] = []
        call_ms = []
        readback: Dict[tuple, tuple] = {}
        snaps: Dict[tuple, list] = {}
        trial_of: Dict[tuple, int] = {}
        first = {s.call: s.replicas for s in samples if s.tag == 0}
        later = {s.call: s.replicas for s in samples if s.tag == 1}
        non_finite = 0
        clock = time.perf_counter

        def span(name, fn, *a):
            t0 = clock()
            r = fn(*a)
            spans.append((name, t0, clock()))
            return r

        clock0 = (clock(), time.time_ns())
        t_start = clock()
        deadline = t_start + float(seconds)
        calls, trial, t_end, done = 0, 0, t_start, False
        n = self.calls_per_trial
        while not done:
            carry = params = None  # the last trial's fleet goes before the next is built
            carry, params = span("pb.reinit", self.init_trial, trial)
            want = first if trial == 0 else later
            tag = 0 if trial == 0 else 1
            for c in range(n):
                if c in want:
                    snaps[(tag, c, "before")] = span("pb.snapshot", self.snapshot, carry, want[c])
                t0 = clock()
                dev = span("pb.upload", self.upload, c)
                carry, out = span("pb.step", self.call, carry, params, dev)
                pos, nm = span("pb.readback", self.read_back, out)
                t_end = clock()
                del dev, out
                call_ms.append((t_end - t0) * 1e3)
                calls += 1
                non_finite += int((~np.isfinite(pos).all(axis=-1)).sum())
                if c in want:
                    snaps[(tag, c, "after")] = span("pb.snapshot", self.snapshot, carry, want[c])
                    readback[(tag, c)] = (pos, nm)
                    trial_of[(tag, c)] = trial
                later_done = all((1, k) in trial_of for k in later)
                if t_end >= deadline and (trial > 0 or c == n - 1) and later_done:
                    done = True
                    break
            trial += 1
        del carry, params
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()
        return Window(
            seconds=t_end - t_start, calls=calls, scans_per_call=self.chunk,
            replica_scans=calls * self.chunk * self.batch, call_ms=call_ms,
            spans=spans, clock0=clock0, readback=readback, non_finite=non_finite,
            snapshots=snaps, trials=trial, trial_of=trial_of,
        )
