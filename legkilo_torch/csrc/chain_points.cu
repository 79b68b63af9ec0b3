// The whole per-scan ESKF chain from per-point match rows, for sm_90a.
//
// Replaces the JAX package's archived Pallas kernel _chain_kernel_grid
// (tools/experiments/eskf_chain_pallas.py:376, driven by _chain_call :481 and
// run_chain :544) and computes what it computes; its contract is that of
// filter_deferred._chain_jax.  For each bucket: each event slot runs a
// dual-clock predict of the 30x30 covariance and then the structured 6-row
// IMU update or the 18-row kinematic update; then the bucket predict and the
// information-form point update over the bucket's P points: per point
//
//     h6 = [p_i x R^T n, n],  z = -(n . (R p_i + t) - n.c),  w = m / (r + 1e-4)
//
// summed to the 6x6 normal equations A = sum w h6 h6^T, b = sum w h6 z, then
// G = (I + A P66)^-1, dx = P[:,0:6] G b, P -= P[:,0:6] (G A) P[0:6,:], applied
// only when the bucket has a matched point (sum m > 0.5), which also latches
// the update clock.
//
// Design: the TPU kernel runs one grid step a bucket, in order, with the
// state in VMEM scratch, and contracts over the points with broadcast sums.
// Here ONE thread block of 128 threads walks the buckets in a loop with the
// state in shared memory (lk_chain.cuh, shared with chain_stats.cu).  In the
// point update a thread takes the points tid, tid + 128, ... in that order
// and keeps the 21 distinct entries of A, the 6 of b and sum m in registers;
// the 28 partial sums are reduced by warp shuffles (a butterfly, so every
// lane holds the same sum), then across the four warps through shared memory
// in warp order.  No atomics: a run repeats bit for bit.  The 6x6 inverse is
// the closed-form Schur inverse of the plain version (the TPU kernel uses
// Gauss-Jordan).
//
// Bound on the H100: ~260 KB in and ~1-4 MFLOP a scan are well under a
// microsecond at the card's rates; the kernel is a strictly sequential
// recursion on one SM, bound by the latency of its block barriers.

#include "lk_chain.cuh"

namespace {

using namespace lk_chain;

constexpr int NACC = 28;  // 21 of A (upper triangle, row-major), 6 of b, sum m
constexpr int NWARP = NT / 32;

struct Points {
  float part[NWARP][NACC];
  float A[36];
  float b[6];
  float nm;
};

// The bucket's normal equations, summed over its P points in a fixed order.
__device__ void point_sums(const Shared& sh, Points& pt, const float* __restrict__ pi,
                           const float* __restrict__ n, const float* __restrict__ nd,
                           const float* __restrict__ r, const float* __restrict__ m, float gate,
                           int P) {
  const int tid = threadIdx.x;
  const float* R = sh.rot;
  const float* pos = sh.lin;
  float acc[NACC];
#pragma unroll
  for (int q = 0; q < NACC; ++q) acc[q] = 0.f;
  for (int p = tid; p < P; p += NT) {
    const float px = pi[3 * p], py = pi[3 * p + 1], pz = pi[3 * p + 2];
    const float nx = n[3 * p], ny = n[3 * p + 1], nz = n[3 * p + 2];
    const float mv = m[p] * gate;
    // R^T n, then [p_i]x R^T n
    const float ux = nx * R[0] + ny * R[3] + nz * R[6];
    const float uy = nx * R[1] + ny * R[4] + nz * R[7];
    const float uz = nx * R[2] + ny * R[5] + nz * R[8];
    float h[6] = {py * uz - pz * uy, pz * ux - px * uz, px * uy - py * ux, nx, ny, nz};
    const float wx = R[0] * px + R[1] * py + R[2] * pz + pos[0];
    const float wy = R[3] * px + R[4] * py + R[5] * pz + pos[1];
    const float wz = R[6] * px + R[7] * py + R[8] * pz + pos[2];
    const float z = -((nx * wx + ny * wy + nz * wz) - nd[p]);
    const float w = mv / (r[p] + 1e-4f);
    int q = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float hw = h[i] * w;
#pragma unroll
      for (int j = i; j < 6; ++j) acc[q++] += hw * h[j];
      acc[21 + i] += hw * z;
    }
    acc[27] += mv;
  }
#pragma unroll
  for (int q = 0; q < NACC; ++q) {
    float v = acc[q];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    acc[q] = v;
  }
  if ((tid & 31) == 0) {
#pragma unroll
    for (int q = 0; q < NACC; ++q) pt.part[tid >> 5][q] = acc[q];
  }
  __syncthreads();
  if (tid < NACC) {
    float v = pt.part[0][tid];
    for (int wp = 1; wp < NWARP; ++wp) v += pt.part[wp][tid];
    if (tid < 21) {
      int i = 0, left = tid;  // row i of the upper triangle holds 6 - i entries
      while (left >= 6 - i) {
        left -= 6 - i;
        ++i;
      }
      const int j = i + left;
      pt.A[i * 6 + j] = v;
      pt.A[j * 6 + i] = v;
    } else if (tid < 27) {
      pt.b[tid - 21] = v;
    } else {
      pt.nm = v;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NT)
chain_points_kernel(const float* __restrict__ params, const float* __restrict__ clocks,
                    const float* __restrict__ rot0, const float* __restrict__ lin0,
                    const float* __restrict__ cov0, const float* __restrict__ btime,
                    const float* __restrict__ bgate, const float* __restrict__ etime,
                    const float* __restrict__ egate, const float* __restrict__ eacc,
                    const float* __restrict__ egyr, const float* __restrict__ efp,
                    const float* __restrict__ efv, const float* __restrict__ ect,
                    const float* __restrict__ pi, const float* __restrict__ n,
                    const float* __restrict__ nd, const float* __restrict__ r,
                    const float* __restrict__ m, float* orot, float* opos, float* orotcov,
                    float* oposcov, float* onm, float* frot, float* flin, float* fcov,
                    float* fclocks, int nb, int kmax, int P, int use_kin) {
  __shared__ Shared sh;
  __shared__ Points pt;
  __shared__ float prm[40];
  load_state(sh, prm, params, clocks, rot0, lin0, cov0);
  for (int b = 0; b < nb; ++b) {
    run_events(sh, prm, b, kmax, etime, egate, eacc, egyr, efp, efv, ect, use_kin);
    const float t = btime[b], g = bgate[b];
    const float lp = sh.clk[0], lu = sh.clk[1];
    predict(sh, prm, (t - lp) * g, (t - lu) * g);
    const size_t row = static_cast<size_t>(b) * P;
    point_sums(sh, pt, pi + 3 * row, n + 3 * row, nd + row, r + row, m + row, g, P);
    const float nm = pt.nm;
    const bool did = nm > 0.5f;  // the same for every thread: read after the barrier
    if (did) info_update(sh, pt.A, 6, pt.b, 1);
    finish_bucket(sh, b, t, g, did, nm, orot, opos, orotcov, oposcov, onm);
  }
  store_final(sh, frot, flin, fcov, fclocks);
}

}  // namespace

LK_API int chain_points_launch(const float* params, const float* clocks, const float* rot0,
                               const float* lin0, const float* cov0, const float* btime,
                               const float* bgate, const float* etime, const float* egate,
                               const float* eacc, const float* egyr, const float* efp,
                               const float* efv, const float* ect, const float* pi, const float* n,
                               const float* nd, const float* r, const float* m, float* orot,
                               float* opos, float* orotcov, float* oposcov, float* onm,
                               float* frot, float* flin, float* fcov, float* fclocks, int nb,
                               int kmax, int P, int use_kin, void* stream) {
  chain_points_kernel<<<1, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      params, clocks, rot0, lin0, cov0, btime, bgate, etime, egate, eacc, egyr, efp, efv, ect, pi,
      n, nd, r, m, orot, opos, orotcov, oposcov, onm, frot, flin, fcov, fclocks, nb, kmax, P,
      use_kin);
  return static_cast<int>(cudaGetLastError());
}
