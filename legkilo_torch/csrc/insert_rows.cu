// Insert-phase moment rows, for sm_90a.
//
// Replaces the JAX package's Pallas kernel _moments_kernel
// (legkilo_tpu/ops/pallas/insert_rows.py:46, driven by moments_call :148)
// and computes what it computes, a row at a time:
//
//   p_w = R_b p_i + t_b                       (post-update bucket pose)
//   var = (R_b E) bc (R_b E)^T + (R_b [p_i]x) C_rr (R_b [p_i]x)^T + C_pp
//   p~  = p_w - (key + 0.5) size[lvl]
//   row = [m1(3) m2(6) | s0(6) s1(18) s2(36)]   (voxel_map._pack_moments)
//
// It reads its rows by index (ops/insert_rows.moments_rows_call): a row's
// point is pidx[r], the point's bucket min(bidx[p], NB - 1), and p_i / the
// sensor covariance are read at the strides the keys kernel leaves them
// ([component, point]); a row's point, level or bucket outside its table
// (pidx past N, lvl past L, a negative bidx) traps the kernel.  The JAX
// layout fed it a [30, R] per-row copy of the bucket's pose and
// covariances, built by a gather and a transpose in front of every launch,
// and the first port ran a thread a row in 32 blocks of 128 (100 of 132
// SMs idle) writing [69, R] at a 4R-byte stride.  Here:
//
//   * a block is one warp and a tile of 32 rows, so R = 4096 is 128 blocks
//     over the card's 132 SMs;
//   * every row reads its bucket's 30 floats by index from the chain's
//     outputs, through L1: a tile's rows share one or two buckets, so the
//     warp's loads broadcast.  Staging the NB bucket rows in shared memory
//     first (cp.async, 4- or 16-byte copies) measured slower on the H100
//     (PERF.md, section 6): the kernel is three dependent load latencies
//     long, and the copies delayed the first of them;
//   * the tile's 69 outputs a row go to shared memory and leave as two
//     contiguous spans, mom [R, 9] and moms [R, 60] row-major, in 16-byte
//     stores: every store instruction of the warp writes 512 consecutive
//     bytes.
//
// A fleet of B replicas is one launch: the buckets are the replicas'
// buckets side by side (NBr = NB / B a replica), the points and rows the
// replicas' points and rows, every index global; a row reads the extrinsic
// rotation of its bucket's replica, ext + 9 * (bucket / NBr).  The traps
// check the fleet's sizes.  With B = 1, NBr = NB: the single launch.
//
// Arithmetic as the first port: fp32 with FMA contraction (chip_smoke holds
// it at rel 1e-4 a moment row against moments_plain).
//
// Bound on the H100 at the main path's R = 4096, NB = 28, 3,584 points: it
// reads the bucket table, p_i and its covariance for the points the rows
// name, and the rows' indices, keys and levels (~0.3 MB) and writes 69 floats
// a row (1.1 MB): ~0.4 us at 3.35 TB/s; ~380 flops a row.  Launch latency
// and the three dependent loads dominate.

#include "lk_common.cuh"

namespace {

constexpr int kRows = 32;       // rows a tile; a block is one warp
constexpr int kMomW = 9;
constexpr int kMomsW = 60;

struct MomentsArgs {
  const float* ext;        // [B, 9] ext_r row-major, a row a replica
  const float* sizes;      // voxel size by level
  const float* rots;       // [NB, 9]
  const float* poss;       // [NB, 3]
  const float* rcov;       // [NB, 9]
  const float* pcov;       // [NB, 9]
  const float* p_i;        // [N, 3] at (pi_sr, pi_sc)
  const float* bcov;       // [N, 9] at (bc_sr, bc_sc)
  const long long* pidx;   // [R]
  const long long* bidx;   // [N]
  const int* keys;         // [R, 3] at (key_sr, key_sc)
  const long long* lvl;    // [R] at lvl_s
  float* mom;              // [R, 9]
  float* moms;             // [R, 60]
  int R, NB, N, L, pi_sr, pi_sc, bc_sr, bc_sc, key_sr, key_sc, lvl_s, nb_rep;
};

__device__ __forceinline__ void sandwich(const float m[9], const float c[9], float out[9]) {
  float t[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      t[3 * i + j] = m[3 * i + 0] * c[0 + j] + m[3 * i + 1] * c[3 + j] + m[3 * i + 2] * c[6 + j];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[3 * i + j] = t[3 * i + 0] * m[3 * j + 0] + t[3 * i + 1] * m[3 * j + 1] + t[3 * i + 2] * m[3 * j + 2];
}

__global__ void __launch_bounds__(kRows) moments_kernel(const MomentsArgs a) {
  __shared__ __align__(16) float s_mom[kRows * kMomW];
  __shared__ __align__(16) float s_moms[kRows * kMomsW];
  const int lane = threadIdx.x;
  const int r0 = blockIdx.x * kRows;
  const int n_rows = min(kRows, a.R - r0);
  // A dead lane of the last tile computes row R - 1 and stores nothing.
  const int r = min(r0 + lane, a.R - 1);

  // Three dependent loads: the row's indices, the point's rows and bucket,
  // then the bucket's pose and covariances (through L1: a tile's rows
  // share one or two buckets).
  const long long p = a.pidx[r];
  const long long lv = a.lvl[(long long)r * a.lvl_s];
  int ikey[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) ikey[i] = a.keys[(long long)r * a.key_sr + i * a.key_sc];
  const float sz = a.sizes[lv];
  const long long bi = min(a.bidx[p], (long long)(a.NB - 1));
  float pi[3], bc[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) pi[i] = a.p_i[p * a.pi_sr + i * a.pi_sc];
#pragma unroll
  for (int k = 0; k < 9; ++k) bc[k] = a.bcov[p * a.bc_sr + k * a.bc_sc];

  float rot[9], crr[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    rot[k] = __ldg(a.rots + bi * 9 + k);
    crr[k] = __ldg(a.rcov + bi * 9 + k);
  }
  float pw[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    pw[i] = rot[3 * i] * pi[0] + rot[3 * i + 1] * pi[1] + rot[3 * i + 2] * pi[2] + __ldg(a.poss + bi * 3 + i);

  const float* e = a.ext + 9 * (bi / a.nb_rep);  // the bucket's replica
  const float sk[9] = {0.f, -pi[2], pi[1], pi[2], 0.f, -pi[0], -pi[1], pi[0], 0.f};
  float re[9], rc[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      re[3 * i + j] = rot[3 * i + 0] * e[0 + j] + rot[3 * i + 1] * e[3 + j] + rot[3 * i + 2] * e[6 + j];
      rc[3 * i + j] = rot[3 * i + 0] * sk[0 + j] + rot[3 * i + 1] * sk[3 + j] + rot[3 * i + 2] * sk[6 + j];
    }
  float w1[9], w2[9], var[9];
  sandwich(re, bc, w1);
  sandwich(rc, crr, w2);
#pragma unroll
  for (int k = 0; k < 9; ++k) var[k] = w1[k] + w2[k] + __ldg(a.pcov + bi * 9 + k);

  float prel[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) prel[i] = pw[i] - ((float)ikey[i] + 0.5f) * sz;

  // Upper triangles in _SYM6 order: (0,0) (0,1) (0,2) (1,1) (1,2) (2,2).
  const int si[6] = {0, 0, 0, 1, 1, 2}, sj[6] = {0, 1, 2, 1, 2, 2};
  float m2[6], v6[6];
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    m2[q] = prel[si[q]] * prel[sj[q]];
    v6[q] = var[3 * si[q] + sj[q]];
  }
  // An index outside its table traps the kernel, at its end: a branch
  // earlier held back the loads and stores around it (~400 cycles a block).
  const bool bad = lk_outside(p, a.N) | lk_outside(lv, a.L) | lk_outside(bi, a.NB);
  // This row into the tile: m1/m2 at a stride of 9 floats, the 60 sums as
  // 15 vector stores (a row is 240 B; eight lanes a phase hit distinct banks).
  float* om = s_mom + lane * kMomW;
#pragma unroll
  for (int i = 0; i < 3; ++i) om[i] = prel[i];
#pragma unroll
  for (int q = 0; q < 6; ++q) om[3 + q] = m2[q];
  float row[kMomsW];
#pragma unroll
  for (int q = 0; q < 6; ++q) row[q] = v6[q];
#pragma unroll
  for (int v = 0; v < 6; ++v)
#pragma unroll
    for (int i = 0; i < 3; ++i) row[6 + 3 * v + i] = v6[v] * prel[i];
#pragma unroll
  for (int v = 0; v < 6; ++v)
#pragma unroll
    for (int q = 0; q < 6; ++q) row[24 + 6 * v + q] = v6[v] * m2[q];
  float4* os = reinterpret_cast<float4*>(s_moms + lane * kMomsW);
#pragma unroll
  for (int j = 0; j < kMomsW / 4; ++j)
    os[j] = make_float4(row[4 * j], row[4 * j + 1], row[4 * j + 2], row[4 * j + 3]);
  __syncthreads();

  // The tile's rows are contiguous spans of both outputs, 16-byte aligned
  // (a tile starts at a multiple of 32 rows; the wrapper allocates them).
  // A full tile's copies are unrolled so every load is in flight at once.
  float4* gm = reinterpret_cast<float4*>(a.mom + (long long)r0 * kMomW);
  float4* gs = reinterpret_cast<float4*>(a.moms + (long long)r0 * kMomsW);
  const float4* sm4 = reinterpret_cast<const float4*>(s_mom);
  const float4* ss4 = reinterpret_cast<const float4*>(s_moms);
  if (n_rows == kRows) {
    constexpr int kMom4 = kRows * kMomW / 4, kMoms4 = kRows * kMomsW / 4;
    float4 vm[(kMom4 + kRows - 1) / kRows], vs[kMoms4 / kRows];
#pragma unroll
    for (int j = 0; j < (kMom4 + kRows - 1) / kRows; ++j)
      if (lane + kRows * j < kMom4) vm[j] = sm4[lane + kRows * j];
#pragma unroll
    for (int j = 0; j < kMoms4 / kRows; ++j) vs[j] = ss4[lane + kRows * j];
#pragma unroll
    for (int j = 0; j < (kMom4 + kRows - 1) / kRows; ++j)
      if (lane + kRows * j < kMom4) gm[lane + kRows * j] = vm[j];
#pragma unroll
    for (int j = 0; j < kMoms4 / kRows; ++j) gs[lane + kRows * j] = vs[j];
  } else {
    const int n_mom = n_rows * kMomW;
    for (int i = lane; i < n_mom / 4; i += kRows) gm[i] = sm4[i];
    for (int i = 4 * (n_mom / 4) + lane; i < n_mom; i += kRows) a.mom[(long long)r0 * kMomW + i] = s_mom[i];
    for (int i = lane; i < n_rows * (kMomsW / 4); i += kRows) gs[i] = ss4[i];
  }
  if (bad) __trap();
}

}  // namespace

LK_API int moments_rows_launch(const float* ext, const float* sizes, const float* rots, const float* poss,
                               const float* rcov, const float* pcov, const float* p_i, const float* bcov,
                               const long long* pidx, const long long* bidx, const int* keys,
                               const long long* lvl, float* mom, float* moms, int R, int NB, int N, int L,
                               int pi_sr, int pi_sc, int bc_sr, int bc_sc, int key_sr, int key_sc, int lvl_s,
                               int batch, void* stream) {
  if (R <= 0 || batch <= 0) return 0;
  const MomentsArgs a{ext,   sizes, rots,  poss,  rcov,   pcov,   p_i,   bcov, pidx,
                      bidx,  keys,  lvl,   mom,   moms,   R,      NB,    N,    L,
                      pi_sr, pi_sc, bc_sr, bc_sc, key_sr, key_sc, lvl_s, NB / batch};
  moments_kernel<<<lk_blocks(R, kRows), kRows, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
