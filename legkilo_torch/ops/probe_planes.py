"""The fused match's probe and plane gather: CUDA kernel + plain version.

Between the keys and select kernels of the fused path
(core/filter_deferred._match_compact_stats_kernel) each (candidate, row)
walks its probe window in the map's probe table and gathers the plane row
of the slot it finds.  One CUDA entry (``csrc/probe_planes.cu``) and its
plain version, which is the eager glue the kernel replaces (the JAX
package's XLA probe, legkilo_tpu/core/filter_deferred.py:390-424):

    probe_planes_call(ptab, plane, keys_t, idx0_t, capacity, probe, dtype)
        -> (plane_t, flags_t, slot, found, isp)

      ptab    [S, 5] int32   the fleet's flat probe table (S = B*L*C slots;
                             key(3), occupied, is_plane)
      plane   [S, 31]        the flat plane table, f32, f16 or bf16 storage
      keys_t  [6L, R] int32  the keys kernel's keys (candidate j's words at
                             rows 3j .. 3j+2: the own chain's L levels, then
                             the neighbour chain's)
      idx0_t  [2L, R] int32  the keys kernel's probe starts (global slots)
      plane_t [2L*31, R]     each candidate's plane row in ``dtype``,
                             transposed (field f of candidate j at row
                             31j + f); zeros on a miss
      flags_t [4L, R]        found, then is_plane, in ``dtype``
      slot    [L, R] int64   the own chain's slot, S on a miss
      found, isp [L, R] bool the own chain's flags

The window wraps inside the start's own subtable of ``capacity`` slots;
the lowest offset whose slot is occupied and holds all three key words
wins (an empty slot does not end the walk).  ``select_call`` reads
plane_t and flags_t; the insert reads slot, found and isp.

On a CUDA tensor ``probe_planes_call`` runs the kernel, on a CPU one the
plain version.  ``probe_planes_call.launches`` counts the calls that ran
the kernel (one launch a call).
"""

from __future__ import annotations

import torch

from . import _build

I32 = torch.int32
I64 = torch.int64
PTAB_DIM = 5        # key(3), occupied, is_plane (core/voxel_map.py)
PLANE_DIM = 31      # centre_rel(3) normal(3) evals(3) radius(1) plane_var(21)
T_OCC, T_PLANE = 3, 4
# Storage dtypes of the plane table (voxel_map._STORAGE) by the kernel's code for them.
_PLANE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_INT32_MAX = 2 ** 31 - 1


def probe_planes_plain(ptab, plane, keys_t, idx0_t, capacity: int, probe: int, dtype):
    """Plain version of ``probe_planes_call`` (module doc): one wide gather
    of the ptab rows at every probe offset; the first match wins, encoded as
    (offset << 1 | is_plane) and taken by one min."""
    C = capacity
    miss = ptab.shape[0]
    L2, R = idx0_t.shape
    dev = idx0_t.device
    offs = torch.arange(probe, dtype=I64, device=dev)
    idx0 = idx0_t.to(I64)
    h0 = idx0 & (C - 1)
    base = idx0 - h0
    idx = base[:, :, None] + ((h0[:, :, None] + offs) & (C - 1))  # [2L, R, probe]
    k_at = ptab[idx]                                              # [2L, R, probe, 5]
    keys_cmp = keys_t.reshape(L2, 3, R).permute(0, 2, 1)
    match = (k_at[..., T_OCC] > 0) & torch.all(k_at[..., 0:3] == keys_cmp[:, :, None, :], dim=-1)
    big = 2 * probe
    score = torch.where(match, 2 * offs + (k_at[..., T_PLANE] > 0).to(I64), big)
    msel = torch.min(score, dim=-1).values
    found = msel < big
    slot = torch.where(found, base + ((h0 + (msel >> 1)) & (C - 1)), miss)
    isp = ((msel & 1) == 1) & found

    # The plane rows, a miss reading zeros (voxel_map._gather_fill).
    got = plane[torch.clamp(slot, max=miss - 1)]                  # [2L, R, 31]
    plane_at = torch.where((slot < miss)[..., None], got, torch.full_like(got, 0.0)).to(dtype)
    plane_t = plane_at.permute(0, 2, 1).reshape(L2 * PLANE_DIM, R).contiguous()
    flags_t = torch.cat([found.to(dtype), isp.to(dtype)], dim=0)
    L = L2 // 2
    return plane_t, flags_t, slot[0:L], found[0:L], isp[0:L]


def probe_planes_call(ptab, plane, keys_t, idx0_t, capacity: int, probe: int, dtype):
    """The probe-and-gather kernel on a CUDA table, ``probe_planes_plain``
    on a CPU one (module doc).  Refuses, before any launch, tensors of
    another dtype or device or not contiguous, a table that is not [S, 5]
    and [S, 31] or whose S slots are not whole subtables of ``capacity``,
    a capacity that is not a power of two, a probe outside [1, capacity],
    keys and starts that are not [6L, R] and [2L, R] with 1 <= L <= 4, a
    ``dtype`` other than float32, and S or 6L x R at or past 2^31."""
    if ptab.device.type != "cuda":
        return probe_planes_plain(ptab, plane, keys_t, idx0_t, capacity, probe, dtype)
    name = "probe_planes_call"
    S = ptab.shape[0]
    if ptab.dim() != 2 or ptab.shape[1] != PTAB_DIM:
        raise ValueError(f"{name}: ptab has shape {tuple(ptab.shape)}, expected [S, {PTAB_DIM}]")
    if tuple(plane.shape) != (S, PLANE_DIM):
        raise ValueError(f"{name}: plane has shape {tuple(plane.shape)}, expected {(S, PLANE_DIM)}")
    if idx0_t.dim() != 2 or idx0_t.shape[0] % 2 or not 1 <= idx0_t.shape[0] // 2 <= 4:
        raise ValueError(f"{name}: idx0_t has shape {tuple(idx0_t.shape)}, expected [2L, R] with "
                         "1 <= L <= 4")
    L2, R = idx0_t.shape
    if tuple(keys_t.shape) != (3 * L2, R):
        raise ValueError(f"{name}: keys_t has shape {tuple(keys_t.shape)}, expected {(3 * L2, R)}")
    capacity, probe = int(capacity), int(probe)
    if capacity < 1 or capacity & (capacity - 1):
        raise ValueError(f"{name}: capacity {capacity} is not a power of two")
    if S < capacity or S % capacity:
        raise ValueError(f"{name}: the table's {S} slots are not whole subtables of {capacity}")
    if not 1 <= probe <= capacity:
        raise ValueError(f"{name}: probe {probe} is outside [1, {capacity}]")
    if dtype != torch.float32:
        raise ValueError(f"{name}: dtype {dtype}, expected torch.float32 (the kernel writes f32)")
    if plane.dtype not in _PLANE_CODE:
        raise ValueError(f"{name}: plane has dtype {plane.dtype}, expected one of "
                         f"{sorted(str(d) for d in _PLANE_CODE)}")
    if S > _INT32_MAX or 3 * L2 * R > _INT32_MAX:
        raise ValueError(f"{name}: {S} table rows or {3 * L2} x {R} key words reach 2^31")
    args = (ptab, plane, keys_t, idx0_t)
    dev = _build.check_tensors(name, args, [I32, plane.dtype, I32, I32])
    L = L2 // 2
    outs = (
        torch.empty((L2 * PLANE_DIM, R), dtype=torch.float32, device=dev),
        torch.empty((2 * L2, R), dtype=torch.float32, device=dev),
        torch.empty((L, R), dtype=I64, device=dev),
        torch.empty((L, R), dtype=torch.bool, device=dev),
        torch.empty((L, R), dtype=torch.bool, device=dev),
    )
    if R == 0:
        return outs
    _build.launch("probe_planes_launch", args + outs,
                  [R, S, capacity, probe, L, _PLANE_CODE[plane.dtype]])
    probe_planes_call.launches += 1
    return outs


probe_planes_call.launches = 0
