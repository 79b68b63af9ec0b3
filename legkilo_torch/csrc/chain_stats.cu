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
// Bound on the H100: the chain reads ~200 KB (s40 is 6.4 KB a bucket) and
// does ~1-4 MFLOP a scan, i.e. well under a microsecond at the card's rates;
// it is a strictly sequential recursion on one SM, bound by the latency of
// its critical path, not by bytes or flops.
//
// One kernel, chain_warp_kernel<KIN>, for both branches (KIN = use_kin):
// ONE warp of 32 threads a replica.  A fleet of B replicas is one launch of
// B such warps, a block each (so up to one a SM at B <= 132), block r
// reading and writing replica r's rows at their strides: each replica's
// walk is the walk a launch of that replica alone makes.  The TPU kernel walks the buckets as a sequential
// grid with the state in VMEM scratch and its BlockSpec pipeline fetching
// bucket b + 1 during bucket b.  Here lane c keeps column c of the
// covariance in registers, every lane keeps its own copy of the nominal
// state and computes the small inverses, exp3 and the retraction itself,
// and the lanes exchange columns and gain rows through warp-private shared
// buffers: no block barrier; ~9 __syncwarp() a bucket for the IMU branch
// at K = 1 and 16 for the kinematic branch, whose 18x18 inverse is split
// over the lanes (lk_chain_warp.cuh).  The event and bucket rows (with the
// kinematic branch, the feet's rows too) are copied to shared memory
// before the walk, and each bucket's statistics into a two-slot ring with
// cp.async one bucket ahead.

#include "lk_chain_warp.cuh"

namespace {

// The warp's static shared memory: the s40 ring (bucket b in slot b & 1,
// b + 1 in the other), then the buffers of the filter steps.
template <bool KIN>
struct __align__(16) Shared {
  float ring[2][lk_warp::S40];
  lk_warp::SmemOf<KIN> sm;
};

// The bucket walk as one warp (module note; lk_chain_warp.cuh); KIN picks
// the event update.
template <bool KIN>
__global__ void __launch_bounds__(lk_warp::NW)
chain_warp_kernel(const float* __restrict__ params, const float* __restrict__ clocks,
                  const float* __restrict__ rot0, const float* __restrict__ lin0,
                  const float* __restrict__ cov0, const float* __restrict__ brow,
                  const float* __restrict__ etime, const float* __restrict__ egate,
                  const float* __restrict__ eacc, const float* __restrict__ egyr,
                  const float* __restrict__ efp, const float* __restrict__ efv,
                  const float* __restrict__ ect, const float* __restrict__ s40, float* orot,
                  float* opos, float* orotcov, float* oposcov, float* onm, float* frot,
                  float* flin, float* fcov, float* fclocks, int nb, int kmax) {
  namespace w = lk_warp;
  // Replica blockIdx.x of a fleet: every input and output at its stride.
  // The inputs staged or read before the walk are shifted here; the ones
  // the walk and its end use are indexed from rb, the replica's first
  // bucket (shifted pointers would hold registers through the walk).
  const int rep = blockIdx.x, rb = rep * nb;
  {
    const size_t r = rep, ev = static_cast<size_t>(nb) * kmax;
    params += r * 40;
    clocks += r * 2;
    rot0 += r * 9;
    lin0 += r * 27;
    cov0 += r * 900;
    brow += r * 3 * nb;
    etime += r * ev;
    egate += r * ev;
    eacc += r * 3 * ev;
    egyr += r * 3 * ev;
    efp += r * 12 * ev;
    efv += r * 12 * ev;
    ect += r * 4 * ev;
  }
  __shared__ Shared<KIN> sh;
  w::SmemOf<KIN>& sm = sh.sm;
  float(&ring)[2][w::S40] = sh.ring;
  // brow | etime | egate | eacc | egyr, and with KIN efp | efv | ect
  extern __shared__ __align__(16) float staged[];
  const int lane = threadIdx.x;
  const int nev = nb * kmax;
  float* s_brow = staged;
  float* s_et = s_brow + 3 * nb;
  float* s_eg = s_et + nev;
  float* s_acc = s_eg + nev;
  float* s_gyr = s_acc + 3 * nev;
  float* s_fp = s_gyr + 3 * nev;
  float* s_fv = s_fp + 12 * nev;
  float* s_ct = s_fv + 12 * nev;
  w::stage(s_brow, brow, 3 * nb, lane);
  w::stage(s_et, etime, nev, lane);
  w::stage(s_eg, egate, nev, lane);
  w::stage(s_acc, eacc, 3 * nev, lane);
  w::stage(s_gyr, egyr, 3 * nev, lane);
  if constexpr (KIN) {
    w::stage(s_fp, efp, 12 * nev, lane);
    w::stage(s_fv, efv, 12 * nev, lane);
    w::stage(s_ct, ect, 4 * nev, lane);
  }
  w::stage(sm.prm, params, 40, lane);
  w::cp_commit();
  // nb * 6,400 B a replica: every replica's s40 stays 16-byte aligned.
  if (nb > 0) w::stage_s40(ring[0], s40 + static_cast<size_t>(rb) * w::S40, lane);
  w::cp_commit();
  float p[30], rot[9], lin[27];
#pragma unroll
  for (int r = 0; r < 30; ++r) p[r] = lane < 30 ? cov0[r * 30 + lane] : 0.f;
#pragma unroll
  for (int k = 0; k < 9; ++k) rot[k] = rot0[k];
#pragma unroll
  for (int k = 0; k < 27; ++k) lin[k] = lin0[k];
  float lp = clocks[0], lu = clocks[1];
  w::cp_wait<1>();  // the event rows and params (bucket 0's statistics may still fly)
  __syncwarp();
  const float qc = lane < 30 ? sm.prm[lane] : 0.f;
  const float g_over_an = sm.prm[36];
  for (int b = 0; b < nb; ++b) {
    if (b + 1 < nb)
      w::stage_s40(ring[(b + 1) & 1], s40 + static_cast<size_t>(rb + b + 1) * w::S40, lane);
    w::cp_commit();  // possibly empty: one group a bucket keeps cp_wait<1> exact
    for (int k = 0; k < kmax; ++k) {
      const int ev = b * kmax + k;
      const float t = s_et[ev], g = s_eg[ev];
      w::predict(p, rot, lin, qc, lane, (t - lp) * g, (t - lu) * g, sm);
      if constexpr (KIN) {
        w::update_kin(p, rot, lin, lane, s_acc + 3 * ev, s_gyr + 3 * ev, s_fp + 12 * ev,
                      s_fv + 12 * ev, s_ct + 4 * ev, sm.prm + 30, sm.prm[37], g_over_an, g, sm);
      } else {
        w::update_imu(p, rot, lin, lane, s_acc + 3 * ev, s_gyr + 3 * ev, sm.prm + 30, g_over_an,
                      g, sm);
      }
      if (g > 0.5f) {
        lp = t;
        lu = t;
      }
    }
    const float t = s_brow[3 * b], g = s_brow[3 * b + 1], nm = s_brow[3 * b + 2];
    w::predict(p, rot, lin, qc, lane, (t - lp) * g, (t - lu) * g, sm);
    if (g > 0.5f) lp = t;
    w::cp_wait<1>();  // bucket b's statistics
    __syncwarp();
    w::update_stats(p, rot, lin, lane, ring[b & 1], sm);
    if (g > 0.5f && nm > 0.5f) lu = t;
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 9; ++k) orot[9 * (rb + b) + k] = rot[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) opos[3 * (rb + b) + k] = lin[k];
      onm[rb + b] = nm;
    }
    if (lane < 3) {
#pragma unroll
      for (int i = 0; i < 3; ++i) orotcov[9 * (rb + b) + 3 * i + lane] = p[i];
    } else if (lane < 6) {
#pragma unroll
      for (int i = 0; i < 3; ++i) oposcov[9 * (rb + b) + 3 * i + lane - 3] = p[3 + i];
    }
  }
  if (lane < 30) {
#pragma unroll
    for (int r = 0; r < 30; ++r) fcov[900 * rep + r * 30 + lane] = p[r];
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) frot[9 * rep + k] = rot[k];
#pragma unroll
    for (int k = 0; k < 27; ++k) flin[27 * rep + k] = lin[k];
    fclocks[2 * rep] = lp;
    fclocks[2 * rep + 1] = lu;
  }
}


// The staged event rows: nb (3 + 8 kmax) floats of dynamic shared memory,
// nb (3 + 36 kmax) with the feet's rows; the opt-in above 48 KB in all.
template <bool KIN>
int launch_warp(const float* params, const float* clocks, const float* rot0, const float* lin0,
                const float* cov0, const float* brow, const float* etime, const float* egate,
                const float* eacc, const float* egyr, const float* efp, const float* efv,
                const float* ect, const float* s40, float* orot, float* opos, float* orotcov,
                float* oposcov, float* onm, float* frot, float* flin, float* fcov,
                float* fclocks, int nb, int kmax, int batch, cudaStream_t st) {
  if (batch <= 0) return 0;
  const size_t dyn = static_cast<size_t>(nb) * (3 + (KIN ? 36 : 8) * kmax) * sizeof(float);
  if (dyn + sizeof(Shared<KIN>) > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        chain_warp_kernel<KIN>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(dyn));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  chain_warp_kernel<KIN><<<batch, lk_warp::NW, dyn, st>>>(
      params, clocks, rot0, lin0, cov0, brow, etime, egate, eacc, egyr, efp, efv, ect, s40, orot,
      opos, orotcov, oposcov, onm, frot, flin, fcov, fclocks, nb, kmax);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

LK_API int chain_stats_launch(const float* params, const float* clocks, const float* rot0,
                              const float* lin0, const float* cov0, const float* brow,
                              const float* etime, const float* egate, const float* eacc,
                              const float* egyr, const float* efp, const float* efv,
                              const float* ect, const float* s40, float* orot, float* opos,
                              float* orotcov, float* oposcov, float* onm, float* frot,
                              float* flin, float* fcov, float* fclocks, int nb, int kmax,
                              int use_kin, int batch, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (use_kin)
    return launch_warp<true>(params, clocks, rot0, lin0, cov0, brow, etime, egate, eacc, egyr,
                             efp, efv, ect, s40, orot, opos, orotcov, oposcov, onm, frot, flin,
                             fcov, fclocks, nb, kmax, batch, st);
  return launch_warp<false>(params, clocks, rot0, lin0, cov0, brow, etime, egate, eacc, egyr, efp,
                            efv, ect, s40, orot, opos, orotcov, oposcov, onm, frot, flin, fcov,
                            fclocks, nb, kmax, batch, st);
}
