// The sequential ESKF chain over one scan's time buckets, for sm_90a.
//
// Replaces the JAX package's Pallas kernel _kernel (ops/pallas/chain_stats.py:348,
// driven by _chain_call :444 / run_chain_stats :504) and computes what it
// computes.  For each bucket: each event slot runs a dual-clock predict of
// the 30x30 covariance (eskf.cc:64-89) and then the structured 6-row IMU
// update (eskf.cc:125-135) or the 18-row kinematic update with the
// nested-Schur 18x18 inverse (KILO.cc:260-314); then the bucket predict and
// the information-form point update from the bucket's 40x40 sufficient
// statistics (core/eskf_fused.point_update_from_stats).
//
// Design: the TPU kernel walks the buckets as a sequential grid with the
// state in VMEM scratch; here ONE thread block walks them in a loop with the
// state (cov 30x30, rot, lin, the two clocks) in shared memory.  The 128
// threads split every product over matrix entries; the 3x3 adjugate
// inverses, exp3 and the state retraction run on one thread.  All
// arithmetic is fp32 on CUDA cores.
//
// Bound on the H100: the chain reads ~200 KB (s40 is 6.4 KB a bucket) and
// does ~1-3 MFLOP a scan, i.e. well under a microsecond at the card's
// rates; it is a strictly sequential recursion on one SM, bound by the
// latency of its ~60-200 block barriers a bucket, not by bytes or flops.

// The predict and the updates are the device functions of lk_chain.cuh,
// shared with the per-point chain kernel (chain_points.cu).

#include "lk_chain.cuh"

namespace {

using namespace lk_chain;

// Scratch of the point update: the bucket's statistics and Phi^T S Phi.
struct Stats {
  float S[1600];
  float sphi[280];
  float nq[49];
};

// Information-form point update from S = sum w X X^T (eskf_fused
// point_update_from_stats); S = 0 is an exact no-op.
__device__ void update_points(Shared& sh, Stats& st, const float* s40) {
  const int tid = threadIdx.x;
  for (int e = tid; e < 1600; e += NT) st.S[e] = s40[e];
  __syncthreads();
  const float* R = sh.rot;
  const float* pos = sh.lin;
  for (int e = tid; e < 280; e += NT) {  // S Phi
    const int i = e / 7, j = e % 7;
    const float* Si = st.S + i * 40;
    float v;
    if (j < 3) {
      v = R[0] * Si[9 * j];
      for (int q = 1; q < 9; ++q) v = v + R[q] * Si[9 * j + q];
    } else if (j < 6) {
      v = Si[24 + j];
    } else {
      v = Si[39] - Si[27] * pos[0] - Si[28] * pos[1] - Si[29] * pos[2];
      for (int q = 0; q < 9; ++q) v = v - R[q] * Si[30 + q];
    }
    st.sphi[e] = v;
  }
  __syncthreads();
  for (int e = tid; e < 49; e += NT) {  // Phi^T (S Phi)
    const int i = e / 7, j = e % 7;
    const float* W = st.sphi;
    float v;
    if (i < 3) {
      v = R[0] * W[(9 * i) * 7 + j];
      for (int q = 1; q < 9; ++q) v = v + R[q] * W[(9 * i + q) * 7 + j];
    } else if (i < 6) {
      v = W[(24 + i) * 7 + j];
    } else {
      v = W[39 * 7 + j] - W[27 * 7 + j] * pos[0] - W[28 * 7 + j] * pos[1] - W[29 * 7 + j] * pos[2];
      for (int q = 0; q < 9; ++q) v = v - R[q] * W[(30 + q) * 7 + j];
    }
    st.nq[e] = v;
  }
  __syncthreads();
  info_update(sh, st.nq, 7, st.nq + 6, 7);  // A = nq[0:6, 0:6], b = nq[0:6, 6]
}

__global__ void __launch_bounds__(NT)
chain_kernel(const float* __restrict__ params, const float* __restrict__ clocks,
             const float* __restrict__ rot0, const float* __restrict__ lin0,
             const float* __restrict__ cov0, const float* __restrict__ brow,
             const float* __restrict__ etime, const float* __restrict__ egate,
             const float* __restrict__ eacc, const float* __restrict__ egyr,
             const float* __restrict__ efp, const float* __restrict__ efv,
             const float* __restrict__ ect, const float* __restrict__ s40, float* orot,
             float* opos, float* orotcov, float* oposcov, float* onm, float* frot, float* flin,
             float* fcov, float* fclocks, int nb, int kmax, int use_kin) {
  __shared__ Shared sh;
  __shared__ Stats st;
  __shared__ float prm[40];
  load_state(sh, prm, params, clocks, rot0, lin0, cov0);
  for (int b = 0; b < nb; ++b) {
    run_events(sh, prm, b, kmax, etime, egate, eacc, egyr, efp, efv, ect, use_kin);
    const float t = brow[3 * b], g = brow[3 * b + 1], nm = brow[3 * b + 2];
    const float lp = sh.clk[0], lu = sh.clk[1];
    predict(sh, prm, (t - lp) * g, (t - lu) * g);
    update_points(sh, st, s40 + static_cast<size_t>(b) * 1600);
    finish_bucket(sh, b, t, g, nm > 0.5f, nm, orot, opos, orotcov, oposcov, onm);
  }
  store_final(sh, frot, flin, fcov, fclocks);
}

}  // namespace

LK_API int chain_stats_launch(const float* params, const float* clocks, const float* rot0,
                              const float* lin0, const float* cov0, const float* brow,
                              const float* etime, const float* egate, const float* eacc,
                              const float* egyr, const float* efp, const float* efv,
                              const float* ect, const float* s40, float* orot, float* opos,
                              float* orotcov, float* oposcov, float* onm, float* frot,
                              float* flin, float* fcov, float* fclocks, int nb, int kmax,
                              int use_kin, void* stream) {
  chain_kernel<<<1, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      params, clocks, rot0, lin0, cov0, brow, etime, egate, eacc, egyr, efp, efv, ect, s40, orot,
      opos, orotcov, oposcov, onm, frot, flin, fcov, fclocks, nb, kmax, use_kin);
  return static_cast<int>(cudaGetLastError());
}
