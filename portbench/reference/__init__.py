"""The plain reference the benchmark holds ``legkilo_torch`` against.

Written for the benchmark from the filter's mathematics, not from the
port's code: NumPy, float64, one replica at a time.  It imports nothing of
``legkilo_torch`` and nothing of JAX.

- ``inputs``: the scan packets (time buckets of the decimated,
  down-sampled scan and the IMU or kinematic events before each bucket),
  the first-frame inputs and each replica's process-noise jitter, worked
  out from the raw scans and events;
- ``eskf``: the 30-dimensional error-state Kalman filter: predict, the IMU
  update, the IMU and leg-kinematics update, and the LiDAR point-to-plane
  update, each in its textbook form (explicit Jacobians, a dense gain);
- ``voxels``: the voxel map as a dictionary from (level, voxel key) to a
  voxel's point moments and fitted plane, with the plane and its 6x6
  covariance fitted by eigendecomposition;
- ``filter``: the first-frame initialisation and one scan step of the
  fused path (every bucket's matched points at the bucket's predicted
  pose, updated at the filter's own state) and of the per-point path.

``arith.Arith`` sets the precision: float64 for the reference, float32
with TF32-rounded products for the control (portbench/control.py).
"""
