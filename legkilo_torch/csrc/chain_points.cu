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
// Bound on the H100: ~270 KB in and ~2-5 MFLOP a scan are well under a
// microsecond at the card's rates; the kernel is a strictly sequential
// recursion on one SM, bound by the latency of its critical path.
//
// Design: the TPU kernel runs one grid step a bucket, in order, with the
// state in VMEM scratch, contracts over the points with broadcast sums, and
// its BlockSpec pipeline fetches bucket b + 1 during bucket b.  Here ONE
// kernel, chain_points_warp_kernel<KIN> (KIN = use_kin), runs ONE warp of 32
// lanes for both branches, on the device functions of the fused chain
// (lk_chain_warp.cuh): lane c keeps column c of the covariance in
// registers, every lane its own copy of the nominal state and clocks.  The
// event rows (with KIN, the feet's rows too) are copied to shared memory
// before the walk, and each bucket's point rows (9 P floats) into a
// two-slot ring one bucket ahead: five bulk copies (the Tensor Memory
// Accelerator) issued by one lane where the rows are 16-byte aligned, and
// completing on an mbarrier a slot, else 4-byte cp.async copies (any P).  In the point phase lane l takes the
// rows l, l + 32, ... in that order and keeps the 21 entries of A's upper
// triangle, the 6 of b and sum m in registers; an xor butterfly of shuffles
// adds them across the warp and leaves the same bits on every lane, so
// every lane takes the same branch on sum m > 0.5 and runs the information
// update, shared with the fused chain, on equal copies.  No block barrier, no atomics: a
// run repeats bit for bit.
//
// A fleet of B replicas (every input and output with a leading B) is one
// launch of B such warps, a block each, block r walking replica r as a
// launch of that replica alone does.

#include "lk_chain_warp.cuh"

namespace {

constexpr int ROW_FLOATS = 9;  // a point row in the ring: pi (3), n (3), nd, r, m

template <bool KIN>
__global__ void __launch_bounds__(lk_warp::NW)
chain_points_warp_kernel(const float* __restrict__ params, const float* __restrict__ clocks,
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
                         float* fclocks, int nb, int kmax, int P, int bulk) {
  namespace w = lk_warp;
  // Replica blockIdx.x of a fleet: every input and output at its stride.
  // The inputs staged or read before the walk are shifted here; the point
  // rows and the outputs are indexed from rb, the replica's first bucket,
  // at each use (a shifted pointer would hold registers through the walk).
  const int rep = blockIdx.x, rb = rep * nb;
  {
    const size_t q = rep, ev = static_cast<size_t>(nb) * kmax;
    params += q * 40;
    clocks += q * 2;
    rot0 += q * 9;
    lin0 += q * 27;
    cov0 += q * 900;
    btime += q * nb;
    bgate += q * nb;
    etime += q * ev;
    egate += q * ev;
    eacc += q * 3 * ev;
    egyr += q * 3 * ev;
    efp += q * 12 * ev;
    efv += q * 12 * ev;
    ect += q * 4 * ev;
  }
  __shared__ w::SmemOf<KIN> sm;
  __shared__ __align__(8) unsigned long long bar[2];  // with bulk: slot s's copies
  // the ring's two slots of 9 P floats | btime | bgate | etime | egate | eacc
  // | egyr, and with KIN efp | efv | ect
  extern __shared__ __align__(16) float staged[];
  const int lane = threadIdx.x;
  if (bulk && lane == 0) {
    w::mbar_init(&bar[0]);
    w::mbar_init(&bar[1]);
    w::mbar_init_fence();
  }
  __syncwarp();
  const int nev = nb * kmax;
  const int slot = ROW_FLOATS * P;
  float* ring = staged;
  float* s_bt = ring + 2 * slot;
  float* s_bg = s_bt + nb;
  float* s_et = s_bg + nb;
  float* s_eg = s_et + nev;
  float* s_acc = s_eg + nev;
  float* s_gyr = s_acc + 3 * nev;
  float* s_fp = s_gyr + 3 * nev;
  float* s_fv = s_fp + 12 * nev;
  float* s_ct = s_fv + 12 * nev;
  w::stage(s_bt, btime, nb, lane);
  w::stage(s_bg, bgate, nb, lane);
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
  if (nb > 0) {
    const size_t row = static_cast<size_t>(rb) * P;
    w::stage_points(ring, pi + 3 * row, n + 3 * row, nd + row, r + row, m + row, P, bulk, &bar[0],
                    lane);
  }
  w::cp_commit();
  float p[30], rot[9], lin[27];
#pragma unroll
  for (int i = 0; i < 30; ++i) p[i] = lane < 30 ? cov0[i * 30 + lane] : 0.f;
#pragma unroll
  for (int k = 0; k < 9; ++k) rot[k] = rot0[k];
#pragma unroll
  for (int k = 0; k < 27; ++k) lin[k] = lin0[k];
  float lp = clocks[0], lu = clocks[1];
  w::cp_wait<1>();  // the event rows and params (bucket 0's points may still fly)
  __syncwarp();
  const float qc = lane < 30 ? sm.prm[lane] : 0.f;
  const float g_over_an = sm.prm[36];
  for (int b = 0; b < nb; ++b) {
    __syncwarp();  // every lane is done with the slot that bucket b + 1 refills
    if (b + 1 < nb) {
      const size_t row = static_cast<size_t>(rb + b + 1) * P;
      w::stage_points(ring + ((b + 1) & 1) * slot, pi + 3 * row, n + 3 * row, nd + row, r + row,
                      m + row, P, bulk, &bar[(b + 1) & 1], lane);
    }
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
    const float t = s_bt[b], g = s_bg[b];
    w::predict(p, rot, lin, qc, lane, (t - lp) * g, (t - lu) * g, sm);
    if (g > 0.5f) lp = t;
    // Bucket b's point rows: its 4-byte copies, or its bulk copies (the
    // (b >> 1)-th phase of slot b & 1's barrier).
    w::cp_wait<1>();
    if (bulk) w::mbar_wait(&bar[b & 1], (b >> 1) & 1);
    __syncwarp();
    float acc[w::NACC];
    w::point_rows(ring + (b & 1) * slot, P, g, rot, lin, lane, acc);
    w::butterfly(acc);
    // The same on every lane: the butterfly leaves the same bits on each.
    const float nm = acc[27];
    if (nm > 0.5f) {
      float A[36], bv[6];
      w::normal_eq(acc, A, bv);
      w::info_update(p, rot, lin, lane, A, bv, sm);
      if (g > 0.5f) lu = t;
    }
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
    for (int i = 0; i < 30; ++i) fcov[900 * rep + i * 30 + lane] = p[i];
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

// The wrapper (ops/chain_points.py) keeps the staging within this much
// dynamic shared memory: the 232,448 B a block may opt in to, less room for
// the warp's static buffers.
constexpr size_t STAGED_MAX = 207872;
static_assert(sizeof(lk_warp::KinSmem) + STAGED_MAX <= 232448, "static buffers past the opt-in");

bool aligned16(const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; }

// The ring (2 x 9 P floats) and the staged event rows, nb (2 + 8 kmax)
// floats, nb (2 + 36 kmax) with the feet's rows: dynamic shared memory, with
// the opt-in above 48 KB in all; the same for every replica, so a fleet of
// up to 132 replicas is one wave, a block an SM.  The bulk copies need
// every replica's row bases 16-byte aligned: replica r's rows start
// 4 (r nb + b) P bytes (x3 for pi and n) past the bases, so P % 4 == 0 and
// aligned bases give it for the whole launch; else every block takes the
// 4-byte copies.
template <bool KIN>
int launch_points_warp(const float* params, const float* clocks, const float* rot0,
                       const float* lin0, const float* cov0, const float* btime,
                       const float* bgate, const float* etime, const float* egate,
                       const float* eacc, const float* egyr, const float* efp, const float* efv,
                       const float* ect, const float* pi, const float* n, const float* nd,
                       const float* r, const float* m, float* orot, float* opos, float* orotcov,
                       float* oposcov, float* onm, float* frot, float* flin, float* fcov,
                       float* fclocks, int nb, int kmax, int P, int batch, cudaStream_t st) {
  if (batch <= 0) return 0;
  const size_t dyn =
      (static_cast<size_t>(2) * ROW_FLOATS * P + static_cast<size_t>(nb) * (2 + (KIN ? 36 : 8) * kmax)) *
      sizeof(float);
  if (dyn > STAGED_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (dyn + sizeof(lk_warp::SmemOf<KIN>) > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(chain_points_warp_kernel<KIN>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(dyn));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int bulk = P > 0 && P % 4 == 0 && aligned16(pi) && aligned16(n) && aligned16(nd) &&
                   aligned16(r) && aligned16(m);
  chain_points_warp_kernel<KIN><<<batch, lk_warp::NW, dyn, st>>>(
      params, clocks, rot0, lin0, cov0, btime, bgate, etime, egate, eacc, egyr, efp, efv, ect, pi,
      n, nd, r, m, orot, opos, orotcov, oposcov, onm, frot, flin, fcov, fclocks, nb, kmax, P, bulk);
  return static_cast<int>(cudaGetLastError());
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
                               int kmax, int P, int use_kin, int batch, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (use_kin)
    return launch_points_warp<true>(params, clocks, rot0, lin0, cov0, btime, bgate, etime, egate,
                                    eacc, egyr, efp, efv, ect, pi, n, nd, r, m, orot, opos,
                                    orotcov, oposcov, onm, frot, flin, fcov, fclocks, nb, kmax, P,
                                    batch, st);
  return launch_points_warp<false>(params, clocks, rot0, lin0, cov0, btime, bgate, etime, egate,
                                   eacc, egyr, efp, efv, ect, pi, n, nd, r, m, orot, opos, orotcov,
                                   oposcov, onm, frot, flin, fcov, fclocks, nb, kmax, P, batch, st);
}
