"""One rank of the port's sharded fleet, for tests/test_torch_multihost.py.

    python tests/torch_multihost_worker.py RANK WORLD HOST:PORT OUT.npz

Brings up a gloo process group on the CPU (legkilo_torch.parallel.multihost),
starts tests/test_torch_fleet.py's four distinct replicas of the five-kernel
configuration (``small_cfg``, ``distinct_start``; q_diag perturbed by 0.2,
seed 1), keeps this rank's shard of the carry, params and packets, runs
three fleet steps over the ``("replica",)`` mesh, and writes the last
``FleetStats``, the carry shard's 12 leaves and the shard's rows to OUT.npz.
It imports torch, never JAX.
"""

import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

N_REPLICAS = 4
N_STEPS = 3


def fleet_start():
    """(scfg, carry, params, per-step packets) of the four-replica fleet."""
    from legkilo_torch.core.filter_fleet import replica
    from legkilo_torch.parallel import sweep
    from test_torch_fleet import distinct_start, small_cfg

    scfg, carry, params, seqs = distinct_start(small_cfg(), N_REPLICAS)
    params = sweep.perturb_params(replica(params, 0), N_REPLICAS, scale=0.2, seed=1)._replace(
        g_over_acc_norm=params.g_over_acc_norm)
    return scfg, carry, params, sweep.stack_packets(seqs)[:N_STEPS]


def run_fleet(scfg, carry, params, steps, mesh=None):
    """N_STEPS fleet steps (this rank's shard with a mesh); (carry, stats)."""
    from legkilo_torch.parallel.mesh import shard_batch
    from legkilo_torch.parallel.sweep import make_fleet_step

    if mesh is not None:
        carry, params = shard_batch(carry, mesh), shard_batch(params, mesh)
        steps = [shard_batch(pk, mesh) for pk in steps]
    step = make_fleet_step(scfg, mesh=mesh)
    stats = None
    for pk in steps:
        carry, _, stats = step(carry, pk, params)
    return carry, stats


def main() -> int:
    rank, world, coord, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    from legkilo_torch.convert import carry_leaves
    from legkilo_torch.parallel import multihost
    from legkilo_torch.parallel.mesh import make_mesh, shard_rows

    multihost.initialize(coordinator_address=coord, num_processes=world, process_id=rank,
                         device="cpu")
    mesh = make_mesh(device_type="cpu")
    assert mesh.size() == world and mesh.mesh_dim_names == ("replica",)
    carry, stats = run_fleet(*fleet_start(), mesh=mesh)
    rows = shard_rows(mesh, N_REPLICAS)
    np.savez(out, rows=np.arange(N_REPLICAS)[rows], backend=np.asarray(torch.distributed.get_backend()),
             **{f"stats_{k}": v.numpy() for k, v in stats._asdict().items()},
             **{f"leaf_{i:03d}": x.numpy() for i, x in enumerate(carry_leaves(carry))})
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
