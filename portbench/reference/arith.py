"""Precision, and the small geometry the filter is built from.

``Arith`` carries the precision a run of the reference computes in.  The
reference is float64.  The control (portbench/control.py) is the
reference one precision below the configuration's float32 with TF32 off:
float32 arithmetic whose matrix products take TF32 inputs (10 explicit
mantissa bits, rounded to nearest), as a card's tensor cores would.  Every
matrix product of the reference goes through ``Arith.mm`` or
``Arith.ein``.
"""

from __future__ import annotations

import math

import numpy as np


def tf32(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to TF32 (to nearest, ties to even)."""
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~np.uint64(0x1FFF)
    return (b & 0xFFFFFFFF).astype(np.uint32).view(np.float32).reshape(np.shape(x))


class Arith:
    """The reference's precision: ``Arith()`` float64, ``Arith(control=True)``
    float32 with TF32-rounded products."""

    def __init__(self, control: bool = False):
        self.control = bool(control)
        self.dt = np.float32 if control else np.float64

    def f(self, x) -> np.ndarray:
        return np.asarray(x, dtype=self.dt)

    def _in(self, x):
        x = np.asarray(x, dtype=self.dt)
        return tf32(x) if self.control else x

    def mm(self, a, b) -> np.ndarray:
        return np.matmul(self._in(a), self._in(b)).astype(self.dt)

    def ein(self, spec: str, *ops) -> np.ndarray:
        return np.einsum(spec, *(self._in(o) for o in ops)).astype(self.dt)


def skew(v: np.ndarray) -> np.ndarray:
    """[v]x of [..., 3] vectors."""
    v = np.asarray(v)
    out = np.zeros(v.shape + (3,), dtype=v.dtype)
    out[..., 0, 1], out[..., 0, 2] = -v[..., 2], v[..., 1]
    out[..., 1, 0], out[..., 1, 2] = v[..., 2], -v[..., 0]
    out[..., 2, 0], out[..., 2, 1] = -v[..., 1], v[..., 0]
    return out


def exp_so3(ar: Arith, w: np.ndarray) -> np.ndarray:
    """Rodrigues: the rotation of the rotation vector w [3]."""
    w = ar.f(w)
    th = float(np.sqrt(np.dot(w, w)))
    k = skew(w)
    if th < 1e-9:
        return ar.f(np.eye(3)) + k + 0.5 * ar.mm(k, k)
    a = math.sin(th) / th
    b = (1.0 - math.cos(th)) / (th * th)
    return (ar.f(np.eye(3)) + a * k + b * ar.mm(k, k)).astype(ar.dt)


def body_cov(ar: Arith, p: np.ndarray, range_err: float, beam_err_deg: float) -> np.ndarray:
    """Each LiDAR-frame point's measurement covariance [N, 3, 3]: the range
    noise along its bearing, the beam's angular noise across it (the
    upstream's calcBodyCov).  A point with |z| under 1e-8 has its z set to
    1e-4."""
    p = ar.f(p).copy()
    z = p[:, 2]
    p[:, 2] = np.where(np.abs(z) < 1e-8, 1e-4, z)
    rng = np.sqrt((p * p).sum(1))
    d = p / np.maximum(rng, 1e-12)[:, None]
    dz = np.where(np.abs(d[:, 2]) < 1e-12, 1e-12, d[:, 2])
    b1 = np.stack([np.ones_like(dz), np.ones_like(dz), -(d[:, 0] + d[:, 1]) / dz], axis=1)
    b1 /= np.sqrt((b1 * b1).sum(1))[:, None]
    b2 = np.cross(b1, d)
    b2 /= np.sqrt((b2 * b2).sum(1))[:, None]
    a = rng[:, None, None] * ar.mm(skew(d), np.stack([b1, b2], axis=2))
    t2 = math.sin(math.radians(beam_err_deg)) ** 2
    return (range_err ** 2 * ar.ein("ni,nj->nij", d, d) + t2 * ar.ein("nik,njk->nij", a, a)).astype(ar.dt)
