"""The 30-dim ESKF state (port of legkilo_tpu/core/state.py).

Rotation is a 3x3 matrix; the other nine 3-blocks are packed into one flat
27-vector ``lin`` = [pos vel ba bw grav imu_a imu_w bv contact], so boxplus
is one add.  The error state is 30-dim with rotation first (eskf.cc:18-29):
``boxplus`` is its retraction (the sequential pipeline's, core/eskf.py;
the fused chain's plain version has its own, core/eskf_fused.boxplus, on
the exactly rounded products) and ``boxminus`` its difference.  fp32
throughout.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .so3 import exp_so3, log_so3

DIM_STATE = 30
DIM_LIN = 27

POS = slice(0, 3)
VEL = slice(3, 6)
BA = slice(6, 9)
BW = slice(9, 12)
GRAV = slice(12, 15)
IMU_A = slice(15, 18)
IMU_W = slice(18, 21)
BV = slice(21, 24)
CONTACT = slice(24, 27)


class State(NamedTuple):
    """Nominal filter state: rotation matrix + flat linear block."""

    rot: torch.Tensor  # [..., 3, 3]
    lin: torch.Tensor  # [..., 27]

    @property
    def pos(self) -> torch.Tensor:
        return self.lin[..., POS]

    @property
    def vel(self) -> torch.Tensor:
        return self.lin[..., VEL]

    @property
    def ba(self) -> torch.Tensor:
        return self.lin[..., BA]

    @property
    def bw(self) -> torch.Tensor:
        return self.lin[..., BW]

    @property
    def grav(self) -> torch.Tensor:
        return self.lin[..., GRAV]

    @property
    def imu_a(self) -> torch.Tensor:
        return self.lin[..., IMU_A]

    @property
    def imu_w(self) -> torch.Tensor:
        return self.lin[..., IMU_W]


def make_state(device) -> State:
    """Default state (eskf.cc:5-16): rot = I, gravity (0, 0, -9.81)."""
    lin = torch.zeros(DIM_LIN, device=device)
    lin[GRAV] = torch.tensor([0.0, 0.0, -9.81], device=device)
    return State(rot=torch.eye(3, device=device), lin=lin)


def boxplus(state: State, dx: torch.Tensor) -> State:
    """rot <- rot Exp(dx[0:3]); lin += dx[3:] (State::operator+=, eskf.cc:18-29)."""
    return State(rot=state.rot @ exp_so3(dx[..., 0:3]), lin=state.lin + dx[..., 3:DIM_STATE])


def boxminus(a: State, b: State) -> torch.Tensor:
    """a - b: Log(b.rot^T a.rot) then the linear difference
    (State::operator-, eskf.cc:31-45)."""
    dr = log_so3(b.rot.transpose(-1, -2) @ a.rot)
    return torch.cat([dr, a.lin - b.lin], dim=-1)
