// IMU-propagated per-bucket match poses over one scan's timeline, for sm_90a.
//
// Replaces the JAX package's Pallas kernel _pose_kernel
// (ops/pallas/pose_prop.py:57, driven by pose_call :194) and computes what
// it computes over the flat event/bucket timeline of MP slots:
//
//   par [32]     rot0(9) pos0(3) vel0(3) ba(3) bw(3) grav(3) imu_w(3) imu_a(3)
//                last_predict_t g_over_acc_norm
//   in  [9, MP]  t, gate, is_event, gyr(3), acc(3)
//   out [12, MP] r_end (row-major 9), p_end (3) at every slot
//
//   latch   rates of the last valid event strictly before each slot
//           (w = gyr - bw, a = g/|a| acc - ba), else the carried imu_w/imu_a
//   cummax  the last-predict clock; dt = t - previous valid time, 0 if masked
//   prefix product of the delta rotations exp(w dt), left to right
//   two cumulative sums: velocity dv = dt (R_start a + g), position dt v_start
//
// One thread block, one thread a slot (MP <= 1024).  Every cumulative
// structure is an inclusive Hillis-Steele doubling scan through shared
// memory: a slot reads its neighbour n to the left (or the identity past the
// start), then all write back; the matrix combine keeps the order
// shifted @ current.  The doubling order and lk::F (no FMA contraction) are
// those of ops/pose_prop.pose_plain, so kernel and plain version round the
// sums and products alike.  Masked and padded slots (gate 0) have dt = 0
// and are exact no-ops.
//
// Bound on the H100: 10.9 KB in and out at MP = 128 and ~0.5 k flops a slot;
// one block of MP threads and ~5 log2(MP) barrier pairs: launch and
// barrier latency, not bandwidth or arithmetic, set its time.

#include "lk_common.cuh"
#include "lk_exact.cuh"

namespace {

using lk::F;
using lk::sel;

constexpr int kRot = 0, kPos = 9, kVel = 12, kBa = 15, kBw = 18, kGrav = 21, kImuW = 24,
              kImuA = 27, kLp = 30, kGsc = 31;
constexpr float kNeg = -3.0e38f;
constexpr float kSmallAngle = 1e-6f;  // core/so3._SMALL_ANGLE

// x[k] of the slot n to the left, or fill[k] for the first n slots.  buf holds K rows of mp.
template <int K>
__device__ __forceinline__ void shift(const F x[K], int n, const F fill[K], F o[K], float* buf,
                                      int mp) {
  const int i = threadIdx.x;
#pragma unroll
  for (int k = 0; k < K; ++k) buf[k * mp + i] = x[k].v;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) o[k] = i >= n ? F(buf[k * mp + i - n]) : fill[k];
  __syncthreads();
}

__global__ void pose_kernel(const float* __restrict__ par, const float* __restrict__ in,
                            float* __restrict__ out, int mp) {
  extern __shared__ float buf[];  // [9, mp]
  const int i = threadIdx.x;
  auto s = [&](int k) { return F(par[k]); };

  const F t(in[0 * mp + i]);
  const bool gate = in[1 * mp + i] > 0.5f;
  // Latch scan state: has-event flag, then the six post-update rates.
  F lat[7], zero7[7], lsh[7];
  lat[0] = F(in[2 * mp + i]);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    lat[1 + k] = F(in[(3 + k) * mp + i]) - s(kBw + k);
    lat[4 + k] = s(kGsc) * F(in[(6 + k) * mp + i]) - s(kBa + k);
  }
#pragma unroll
  for (int k = 0; k < 7; ++k) zero7[k] = F(0.f);
  for (int n = 1; n < mp; n *= 2) {
    shift<7>(lat, n, zero7, lsh, buf, mp);
    const bool has = lat[0] > F(0.5f);
#pragma unroll
    for (int k = 1; k < 7; ++k) lat[k] = sel(has, lat[k], lsh[k]);
    lat[0] = lk::fmax(lat[0], lsh[0]);
  }
  shift<7>(lat, 1, zero7, lsh, buf, mp);
  const bool has_p = lsh[0] > F(0.5f);
  F w_seg[3], a_seg[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    w_seg[k] = sel(has_p, lsh[1 + k], s(kImuW + k));
    a_seg[k] = sel(has_p, lsh[4 + k], s(kImuA + k));
  }

  // ---- per-segment dt from the last-predict clock ----
  const F lp = s(kLp);
  F tv[1] = {sel(gate, t, F(kNeg))}, tsh[1];
  const F neg1[1] = {F(kNeg)};
  for (int n = 1; n < mp; n *= 2) {
    shift<1>(tv, n, neg1, tsh, buf, mp);
    tv[0] = lk::fmax(tv[0], tsh[0]);
  }
  const F t_end[1] = {lk::fmax(tv[0], lp)};
  const F lp1[1] = {lp};
  shift<1>(t_end, 1, lp1, tsh, buf, mp);
  const F dt = sel(gate, t - tsh[0], F(0.f));

  // ---- d_r = exp(w_seg dt): Rodrigues with the Taylor branch ----
  const F wx = w_seg[0] * dt, wy = w_seg[1] * dt, wz = w_seg[2] * dt;
  const F th2 = wx * wx + wy * wy + wz * wz;
  const F th = lk::fsqrt(th2);
  const bool small = th < F(kSmallAngle);
  const F safe = sel(small, F(1.f), th);
  const F a_c = sel(small, F(1.f) - th2 * F((float)(1.0 / 6.0)), lk::fsin(safe) / safe);
  const F b_c = sel(small, F(0.5f) - th2 * F((float)(1.0 / 24.0)), (F(1.f) - lk::fcos(safe)) / (safe * safe));
  const F kk[9] = {-(wy * wy + wz * wz), wx * wy, wx * wz,
                   wx * wy, -(wx * wx + wz * wz), wy * wz,
                   wx * wz, wy * wz, -(wx * wx + wy * wy)};
  const F kx[9] = {F(0.f), -wz, wy, wz, F(0.f), -wx, -wy, wx, F(0.f)};
  const F eye[9] = {F(1.f), F(0.f), F(0.f), F(0.f), F(1.f), F(0.f), F(0.f), F(0.f), F(1.f)};
  F pref[9], psh[9], tmp[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) pref[k] = eye[k] + a_c * kx[k] + b_c * kk[k];

  // ---- inclusive prefix product, order-preserving: shifted @ current ----
  for (int n = 1; n < mp; n *= 2) {
    shift<9>(pref, n, eye, psh, buf, mp);
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        tmp[3 * r + c] = psh[3 * r + 0] * pref[0 + c] + psh[3 * r + 1] * pref[3 + c] +
                         psh[3 * r + 2] * pref[6 + c];
#pragma unroll
    for (int k = 0; k < 9; ++k) pref[k] = tmp[k];
  }

  F r0[9], r_end[9], r_start[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) r0[k] = s(kRot + k);
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      r_end[3 * r + c] = r0[3 * r + 0] * pref[0 + c] + r0[3 * r + 1] * pref[3 + c] +
                         r0[3 * r + 2] * pref[6 + c];
  shift<9>(r_end, 1, r0, r_start, buf, mp);

  // ---- v_end = vel0 + cumsum(dt (r_start a_seg + grav)) ----
  F cs[3], csh[3], zero3[3] = {F(0.f), F(0.f), F(0.f)};
#pragma unroll
  for (int k = 0; k < 3; ++k)
    cs[k] = dt * (r_start[3 * k + 0] * a_seg[0] + r_start[3 * k + 1] * a_seg[1] +
                  r_start[3 * k + 2] * a_seg[2] + s(kGrav + k));
  for (int n = 1; n < mp; n *= 2) {
    shift<3>(cs, n, zero3, csh, buf, mp);
#pragma unroll
    for (int k = 0; k < 3; ++k) cs[k] = cs[k] + csh[k];
  }
  F v_end[3], vel0[3], v_start[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    vel0[k] = s(kVel + k);
    v_end[k] = vel0[k] + cs[k];
  }
  shift<3>(v_end, 1, vel0, v_start, buf, mp);

  // ---- p_end = pos0 + cumsum(dt v_start) ----
#pragma unroll
  for (int k = 0; k < 3; ++k) cs[k] = dt * v_start[k];
  for (int n = 1; n < mp; n *= 2) {
    shift<3>(cs, n, zero3, csh, buf, mp);
#pragma unroll
    for (int k = 0; k < 3; ++k) cs[k] = cs[k] + csh[k];
  }

#pragma unroll
  for (int k = 0; k < 9; ++k) out[k * mp + i] = r_end[k].v;
#pragma unroll
  for (int k = 0; k < 3; ++k) out[(9 + k) * mp + i] = (s(kPos + k) + cs[k]).v;
}

}  // namespace

LK_API int pose_launch(const float* par, const float* in, float* out, int mp, void* stream) {
  pose_kernel<<<1, mp, 9 * mp * sizeof(float), static_cast<cudaStream_t>(stream)>>>(par, in, out, mp);
  return static_cast<int>(cudaGetLastError());
}
