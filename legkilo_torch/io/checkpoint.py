"""Filter checkpoint/resume (port of legkilo_tpu/io/checkpoint.py).

The whole filter -- 30-dim state, covariance, clocks and the voxel map -- is
12 dense tensors, so a checkpoint is one compressed npz: ``leaf_000`` ...
``leaf_011`` in the order of convert.carry_to_numpy (the JAX package's
``jax.tree.flatten`` order), an optional ``step``, and ``x_<name>`` entries
for the host-side resume state the runner adds (init-derived gravity scale,
packetizer clocks, pending events, the escalation latch).  The format is the
JAX package's: either package reads the other's files.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from ..convert import (
    _EXTRA_PREFIX,
    carry_from_leaves,
    carry_leaves,
    carry_to_numpy,
    load_jax_checkpoint,
)
from ..core.filter import FilterCarry


def save(path: str, carry: FilterCarry, step: Optional[int] = None,
         extras: Optional[Dict[str, np.ndarray]] = None) -> str:
    """Save a filter checkpoint; returns the written path (``.npz`` added)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    data = {f"leaf_{i:03d}": leaf for i, leaf in enumerate(carry_to_numpy(carry))}
    if step is not None:
        data["step"] = np.asarray(step)
    for k, v in (extras or {}).items():
        data[_EXTRA_PREFIX + k] = np.asarray(v)
    path = path if path.endswith(".npz") else path + ".npz"
    np.savez_compressed(path, **data)
    return path


def load(path: str, carry_like: FilterCarry) -> Tuple[FilterCarry, Optional[int], Dict[str, np.ndarray]]:
    """Restore a checkpoint onto the device and into the shapes and dtypes
    of ``carry_like``; returns (carry, step, extras).  A leaf of another
    shape (a config mismatch) raises ValueError."""
    carry, step, extras = load_jax_checkpoint(path, carry_like.cov.device)
    leaves = []
    for i, (got, like) in enumerate(zip(carry_leaves(carry), carry_leaves(carry_like))):
        if got.shape != like.shape:
            raise ValueError(f"checkpoint leaf {i} shape {tuple(got.shape)} != expected "
                             f"{tuple(like.shape)} (config mismatch?)")
        leaves.append(got.to(like.dtype))
    return carry_from_leaves(leaves), step, extras
