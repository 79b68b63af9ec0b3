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
// A fleet of B replicas is one launch of B blocks: block r reads replica
// r's par and rows at its stride and writes its outputs at its stride, so
// each replica's slots compute what a launch of that replica alone does.
//
// One thread block a replica; each thread takes SPT slots (i, i + T, ... for a block
// of T = MP / SPT <= 1,024 threads), so MP runs to 6,400, where the
// 9 x MP floats of shared memory reach the 227 KB a block may opt in to.
// Every cumulative structure is an inclusive Hillis-Steele doubling scan
// through shared memory: a slot reads its neighbour n to the left (or the
// identity past the start), then all write back; the matrix combine keeps
// the order shifted @ current.  A slot's arithmetic does not depend on SPT.
// The doubling order and lk::F (no FMA contraction) are those of
// ops/pose_prop.pose_plain, so kernel and plain version round the sums and
// products alike.  The latch and the clock's cummax, a select and a max,
// give the same bits in any order, so they share one 8-word scan.  Masked
// and padded slots (gate 0) have dt = 0 and are exact no-ops.
//
// Bound on the H100: 10.9 KB in and out at MP = 128 and ~0.5 k flops a slot;
// one block of MP / SPT threads and ~4 log2(MP) barrier pairs: launch and
// barrier latency, not bandwidth or arithmetic, set its time.  One warp
// holding the timeline in registers (shuffles, no barrier) was slower at
// MP = 128: it issues every slot's work on one of the SM's four schedulers
// (PERF.md section 6).

#include "lk_common.cuh"
#include "lk_exact.cuh"

namespace {

using lk::F;
using lk::sel;

constexpr int kRot = 0, kPos = 9, kVel = 12, kBa = 15, kBw = 18, kGrav = 21, kImuW = 24,
              kImuA = 27, kLp = 30, kGsc = 31;
constexpr float kNeg = -3.0e38f;
constexpr float kSmallAngle = 1e-6f;  // core/so3._SMALL_ANGLE

// Slot j of this thread: SPT slots a thread, strided by the block.
template <int SPT>
__device__ __forceinline__ int slot(int j) {
  return threadIdx.x + j * static_cast<int>(blockDim.x);
}

// x[j][k] of the slot n to the left of each of this thread's slots, or
// fill[k] for the first n slots.  buf holds K rows of mp.
template <int K, int SPT>
__device__ __forceinline__ void shift(const F (&x)[SPT][K], int n, const F (&fill)[K],
                                      F (&o)[SPT][K], float* buf, int mp) {
#pragma unroll
  for (int j = 0; j < SPT; ++j)
#pragma unroll
    for (int k = 0; k < K; ++k) buf[k * mp + slot<SPT>(j)] = x[j][k].v;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    const int i = slot<SPT>(j);
#pragma unroll
    for (int k = 0; k < K; ++k) o[j][k] = i >= n ? F(buf[k * mp + i - n]) : fill[k];
  }
  __syncthreads();
}

template <int SPT>
__global__ void __launch_bounds__(1024)
pose_kernel(const float* __restrict__ par, const float* __restrict__ in,
            float* __restrict__ out, int mp) {
  extern __shared__ float buf[];  // [9, mp]
  // Replica blockIdx.x: its par row and rows, as offsets of the kernel's
  // own pointers (a shifted pointer would hold two registers the whole
  // kernel long, and pose_kernel<2> runs at the 64-register cap).
  const int rep = blockIdx.x;
  auto s = [&](int k) { return F(par[32 * rep + k]); };

  F t[SPT], dt[SPT];
  bool gate[SPT];
  // One scan for the latch (has-event flag, then the six post-update rates)
  // and the last-predict clock (the valid slots' times, word 7).
  const F lp = s(kLp);
  F lat[SPT][8], lsh[SPT][8];
  const F fill[8] = {F(0.f), F(0.f), F(0.f), F(0.f), F(0.f), F(0.f), F(0.f), F(kNeg)};
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    const int i = slot<SPT>(j);
    t[j] = F(in[(9 * rep + 0) * mp + i]);
    gate[j] = in[(9 * rep + 1) * mp + i] > 0.5f;
    lat[j][0] = F(in[(9 * rep + 2) * mp + i]);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      lat[j][1 + k] = F(in[(9 * rep + 3 + k) * mp + i]) - s(kBw + k);
      lat[j][4 + k] = s(kGsc) * F(in[(9 * rep + 6 + k) * mp + i]) - s(kBa + k);
    }
    lat[j][7] = sel(gate[j], t[j], F(kNeg));
  }
  for (int n = 1; n < mp; n *= 2) {
    shift<8, SPT>(lat, n, fill, lsh, buf, mp);
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const bool has = lat[j][0] > F(0.5f);
#pragma unroll
      for (int k = 1; k < 7; ++k) lat[j][k] = sel(has, lat[j][k], lsh[j][k]);
      lat[j][0] = lk::fmax(lat[j][0], lsh[j][0]);
      lat[j][7] = lk::fmax(lat[j][7], lsh[j][7]);
    }
  }
  // Each slot reads the slot before it: the latch, and t_end = max(clock, lp)
  // with lp before the first slot.
  const F fill1[8] = {F(0.f), F(0.f), F(0.f), F(0.f), F(0.f), F(0.f), F(0.f), lp};
#pragma unroll
  for (int j = 0; j < SPT; ++j) lat[j][7] = lk::fmax(lat[j][7], lp);
  shift<8, SPT>(lat, 1, fill1, lsh, buf, mp);
  F w_seg[SPT][3], a_seg[SPT][3];
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    const bool has_p = lsh[j][0] > F(0.5f);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      w_seg[j][k] = sel(has_p, lsh[j][1 + k], s(kImuW + k));
      a_seg[j][k] = sel(has_p, lsh[j][4 + k], s(kImuA + k));
    }
    dt[j] = sel(gate[j], t[j] - lsh[j][7], F(0.f));
  }

  // ---- d_r = exp(w_seg dt): Rodrigues with the Taylor branch ----
  const F eye[9] = {F(1.f), F(0.f), F(0.f), F(0.f), F(1.f), F(0.f), F(0.f), F(0.f), F(1.f)};
  F pref[SPT][9], psh[SPT][9];
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    const F wx = w_seg[j][0] * dt[j], wy = w_seg[j][1] * dt[j], wz = w_seg[j][2] * dt[j];
    const F th2 = wx * wx + wy * wy + wz * wz;
    const F th = lk::fsqrt(th2);
    const bool small = th < F(kSmallAngle);
    const F safe = sel(small, F(1.f), th);
    F sn, cn;
    lk::fsincos(safe, sn, cn);
    const F a_c = sel(small, F(1.f) - th2 * F((float)(1.0 / 6.0)), sn / safe);
    const F b_c = sel(small, F(0.5f) - th2 * F((float)(1.0 / 24.0)), (F(1.f) - cn) / (safe * safe));
    const F kk[9] = {-(wy * wy + wz * wz), wx * wy, wx * wz,
                     wx * wy, -(wx * wx + wz * wz), wy * wz,
                     wx * wz, wy * wz, -(wx * wx + wy * wy)};
    const F kx[9] = {F(0.f), -wz, wy, wz, F(0.f), -wx, -wy, wx, F(0.f)};
#pragma unroll
    for (int k = 0; k < 9; ++k) pref[j][k] = eye[k] + a_c * kx[k] + b_c * kk[k];
  }

  // ---- inclusive prefix product, order-preserving: shifted @ current ----
  for (int n = 1; n < mp; n *= 2) {
    shift<9, SPT>(pref, n, eye, psh, buf, mp);
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      F tmp[9];
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          tmp[3 * r + c] = psh[j][3 * r + 0] * pref[j][0 + c] + psh[j][3 * r + 1] * pref[j][3 + c] +
                           psh[j][3 * r + 2] * pref[j][6 + c];
#pragma unroll
      for (int k = 0; k < 9; ++k) pref[j][k] = tmp[k];
    }
  }

  F r0[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) r0[k] = s(kRot + k);
  F r_end[SPT][9], r_start[SPT][9];
#pragma unroll
  for (int j = 0; j < SPT; ++j)
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        r_end[j][3 * r + c] = r0[3 * r + 0] * pref[j][0 + c] + r0[3 * r + 1] * pref[j][3 + c] +
                              r0[3 * r + 2] * pref[j][6 + c];
  shift<9, SPT>(r_end, 1, r0, r_start, buf, mp);

  // ---- v_end = vel0 + cumsum(dt (r_start a_seg + grav)) ----
  F cs[SPT][3], csh[SPT][3];
  const F zero3[3] = {F(0.f), F(0.f), F(0.f)};
#pragma unroll
  for (int j = 0; j < SPT; ++j)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      cs[j][k] = dt[j] * (r_start[j][3 * k + 0] * a_seg[j][0] + r_start[j][3 * k + 1] * a_seg[j][1] +
                          r_start[j][3 * k + 2] * a_seg[j][2] + s(kGrav + k));
  for (int n = 1; n < mp; n *= 2) {
    shift<3, SPT>(cs, n, zero3, csh, buf, mp);
#pragma unroll
    for (int j = 0; j < SPT; ++j)
#pragma unroll
      for (int k = 0; k < 3; ++k) cs[j][k] = cs[j][k] + csh[j][k];
  }
  F vel0[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) vel0[k] = s(kVel + k);
#pragma unroll
  for (int j = 0; j < SPT; ++j)
#pragma unroll
    for (int k = 0; k < 3; ++k) cs[j][k] = vel0[k] + cs[j][k];  // v_end
  shift<3, SPT>(cs, 1, vel0, csh, buf, mp);                      // v_start

  // ---- p_end = pos0 + cumsum(dt v_start) ----
#pragma unroll
  for (int j = 0; j < SPT; ++j)
#pragma unroll
    for (int k = 0; k < 3; ++k) cs[j][k] = dt[j] * csh[j][k];
  for (int n = 1; n < mp; n *= 2) {
    shift<3, SPT>(cs, n, zero3, csh, buf, mp);
#pragma unroll
    for (int j = 0; j < SPT; ++j)
#pragma unroll
      for (int k = 0; k < 3; ++k) cs[j][k] = cs[j][k] + csh[j][k];
  }

#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    const int i = slot<SPT>(j);
#pragma unroll
    for (int k = 0; k < 9; ++k) out[(12 * rep + k) * mp + i] = r_end[j][k].v;
#pragma unroll
    for (int k = 0; k < 3; ++k) out[(12 * rep + 9 + k) * mp + i] = (s(kPos + k) + cs[j][k]).v;
  }
}

template <int SPT>
int launch(const float* par, const float* in, float* out, int mp, int batch, cudaStream_t st) {
  const int smem = 9 * mp * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(pose_kernel<SPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  pose_kernel<SPT><<<batch, mp / SPT, smem, st>>>(par, in, out, mp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// MP a multiple of 128 up to 6,400 (the wrapper checks): SPT slots a thread,
// the least power of two that keeps the block at 1,024 threads or fewer;
// batch replicas (par [batch, 32], in [batch, 9, MP], out [batch, 12, MP]).
LK_API int pose_launch(const float* par, const float* in, float* out, int mp, int batch, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch <= 0) return 0;
  if (mp <= 1024) return launch<1>(par, in, out, mp, batch, st);
  if (mp <= 2048) return launch<2>(par, in, out, mp, batch, st);
  if (mp <= 4096) return launch<4>(par, in, out, mp, batch, st);
  return launch<8>(par, in, out, mp, batch, st);
}
