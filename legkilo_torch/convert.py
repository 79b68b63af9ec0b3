"""Carry the JAX package's filter state across to the port.

The JAX ``FilterCarry`` flattens (``jax.tree.flatten``) to 12 leaves, and
``legkilo_tpu/io/checkpoint.py`` stores them as ``leaf_000`` ... ``leaf_011``
in a compressed npz.  Their order, which this module is written from and
which needs no JAX to read:

    state.rot, state.lin, cov, last_predict_t, last_update_t,
    vm.ptab, vm.meta, vm.mom, vm.moms, vm.plane, vm.ocnt, last_slide_pos

Both deferred paths (``chain_impl`` "fused" and "jax") carry this same
``FilterCarry`` and write the same checkpoint; nothing is path-specific.

``FilterParams`` flattens to 7 leaves: noise.q_diag, noise.imu_meas_r,
noise.kin_meas_noise, noise.lidar_point_meas_ratio, ext_r, ext_t,
g_over_acc_norm.

A fleet (parallel/sweep.py) is the same trees with a leading replica axis on
every leaf, so the same functions carry it across; its checkpoint adds the
params' leaves as ``x_bp_000`` ... ``x_bp_006`` (the JAX CLI's
``_save_fleet_ckpt``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .core.eskf import NoiseParams
from .core.filter import FilterCarry, FilterParams
from .core.state import State
from .core.voxel_map import VoxelMap

N_CARRY_LEAVES = 12
N_PARAM_LEAVES = 7
_EXTRA_PREFIX = "x_"


def _t(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, order="C")).to(device)


def carry_from_leaves(x: Sequence[torch.Tensor]) -> FilterCarry:
    """FilterCarry from its 12 tensors (module doc order)."""
    if len(x) != N_CARRY_LEAVES:
        raise ValueError(f"expected {N_CARRY_LEAVES} carry leaves, got {len(x)}")
    return FilterCarry(
        state=State(rot=x[0], lin=x[1]), cov=x[2],
        last_predict_t=x[3], last_update_t=x[4],
        vm=VoxelMap(ptab=x[5], meta=x[6], mom=x[7], moms=x[8], plane=x[9], ocnt=x[10]),
        last_slide_pos=x[11],
    )


def carry_leaves(carry: FilterCarry):
    """The 12 tensors of a port carry, in the JAX order."""
    vm = carry.vm
    return [carry.state.rot, carry.state.lin, carry.cov, carry.last_predict_t,
            carry.last_update_t, vm.ptab, vm.meta, vm.mom, vm.moms, vm.plane, vm.ocnt,
            carry.last_slide_pos]


def carry_from_numpy(leaves: Sequence, device) -> FilterCarry:
    """FilterCarry from the 12 JAX carry leaves as numpy arrays."""
    return carry_from_leaves([_t(a, device) for a in leaves])


def carry_to_numpy(carry: FilterCarry):
    """The 12 leaves of a port carry as numpy arrays, in the JAX order."""
    return [t.detach().cpu().numpy() for t in carry_leaves(carry)]


def params_leaves(params: FilterParams):
    """The 7 tensors of port params, in the JAX order."""
    nz = params.noise
    return [nz.q_diag, nz.imu_meas_r, nz.kin_meas_noise, nz.lidar_point_meas_ratio,
            params.ext_r, params.ext_t, params.g_over_acc_norm]


def params_to_numpy(params: FilterParams):
    """The 7 leaves of port params as numpy arrays, in the JAX order."""
    return [t.detach().cpu().numpy() for t in params_leaves(params)]


def params_from_numpy(leaves: Sequence, device) -> FilterParams:
    """FilterParams from the 7 JAX param leaves (module doc order)."""
    if len(leaves) != N_PARAM_LEAVES:
        raise ValueError(f"expected {N_PARAM_LEAVES} param leaves, got {len(leaves)}")
    x = [_t(a, device).to(torch.float32) for a in leaves]
    return FilterParams(
        noise=NoiseParams(q_diag=x[0], imu_meas_r=x[1], kin_meas_noise=x[2],
                          lidar_point_meas_ratio=x[3]),
        ext_r=x[4], ext_t=x[5], g_over_acc_norm=x[6],
    )


def load_jax_checkpoint(path: str, device) -> Tuple[FilterCarry, Optional[int], Dict[str, np.ndarray]]:
    """Read a checkpoint written by ``legkilo_tpu.io.checkpoint.save``;
    returns (carry on ``device``, step, extras such as g_over_acc_norm)."""
    with np.load(path) as data:
        leaves = [data[f"leaf_{i:03d}"] for i in range(N_CARRY_LEAVES)]
        step = int(data["step"]) if "step" in data else None
        extras = {k[len(_EXTRA_PREFIX):]: np.asarray(data[k])
                  for k in data.files if k.startswith(_EXTRA_PREFIX)}
    return carry_from_numpy(leaves, device), step, extras
