// Match-phase kernels of the deferred pipeline, for sm_90a.
//
// Replace the JAX package's Pallas kernels in ops/pallas/match_geom.py:
//   keys   -> _keys_kernel   (match_geom.py:74),  driven by keys_call   (:454)
//   select -> _select_kernel (match_geom.py:254), driven by select_call (:487)
// and compute what they compute, in their [component, row] layout (row r of
// component k at k * C + r).
//
// A fleet of B replicas is one launch of each: the rows are the replicas'
// rows side by side (replica r's rows r * rpr ... r * rpr + rpr - 1, rpr =
// C / B), each replica with its own par row; keys' probe starts name the
// replica's own tables (segment r * L + level of the fleet's flat map), and
// select's buckets are the replicas' buckets side by side (replica r's
// buckets r * NBr ... r * NBr + NBr - 1).  Every row and bucket computes
// what a launch of its replica alone computes: the same inputs, the same
// order of work.  With B = 1 rpr = C and NBr = NB: the single launch.
//
// Bound on the H100: neither kernel is bound by the card's rates at the main
// path's C = 3584 rows.  keys reads 15 and writes 75 floats a row (~1.3 MB,
// 0.4 us of memory traffic) over a dependent chain of ~650 flops a row, so
// its time is the chain's latency and the launch: a 32-row tile a block
// spreads the rows over 112 SMs and splits each row's chain four ways (see
// below).  select reads ~230 floats a row (~3.3 MB, mostly the gathered
// plane rows), writes 46 and sums the per-bucket 40x40 statistics
// s40 = sum w X X^T; it is one launch: a block a bucket that gathers its
// own rows, so the sums read only them (see below).

#include "lk_common.cuh"

namespace {

constexpr float kDeg2Rad = static_cast<float>(3.14159265358979323846 / 180.0);
constexpr float kRJitter = 1e-4f;

// par layout of keys_call (match_geom.py:43-53)
constexpr int P_EXT_R = 0, P_EXT_T = 9, P_SIZES = 12, P_COV_RR = 16, P_COV_PP = 25;
constexpr int P_DEPT = 34, P_BEAM = 35;

__device__ __forceinline__ int sym21(int i, int j) {
  if (i > j) { int t = i; i = j; j = t; }
  return i * 6 + j - (i * (i + 1)) / 2;
}

// out = m @ c @ m^T for row-major 3x3 m and c.
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

// ------------------------------------------------------------------ keys --
//
// A block of four warps owns a tile of 32 consecutive rows, lane = row, so
// every store of a component is one 128 B line and C = 3584 rows make 112
// blocks.  Each warp takes one role for the tile (warp-uniform, no
// divergence): warp 0 p_i, p_w and the own chain's keys, centres and probe
// starts; warp 1 the neighbour chain's (it recomputes p_w with the same
// un-fused expressions, so the same bits); warp 2 the LiDAR-frame sensor
// covariance bc and its world sandwich w1; warp 3 the rotation sandwich w2,
// then, behind the one block barrier, w1 + w2 + C_pp in that order.  par,
// sin(beam) and each level's 1 / size are staged once a block in shared
// memory (an IEEE division and sinf give the same bits once or per row).
// The last tile of a ragged C computes row C - 1 for its dead lanes and
// stores nothing for them.
constexpr int kKeysRows = 32;
constexpr int kKeysThreads = 4 * kKeysRows;

__device__ __forceinline__ void p_lidar_to_imu(const float* e, const float* et, float px, float py, float pz,
                                               float pi[3]) {
  pi[0] = LK_ADD(LK_ADD(LK_ADD(LK_MUL(e[0], px), LK_MUL(e[1], py)), LK_MUL(e[2], pz)), et[0]);
  pi[1] = LK_ADD(LK_ADD(LK_ADD(LK_MUL(e[3], px), LK_MUL(e[4], py)), LK_MUL(e[5], pz)), et[1]);
  pi[2] = LK_ADD(LK_ADD(LK_ADD(LK_MUL(e[6], px), LK_MUL(e[7], py)), LK_MUL(e[8], pz)), et[2]);
}

__global__ void __launch_bounds__(kKeysThreads)
keys_kernel(const float* __restrict__ par, const float* __restrict__ pts, const float* __restrict__ rb,
            const float* __restrict__ pb, float* __restrict__ piw, float* __restrict__ covs,
            int* __restrict__ keys, float* __restrict__ vc, int* __restrict__ idx0, int C, int levels,
            int capacity, int rpr) {
  __shared__ float sp[64];               // par
  __shared__ float tangent_var;          // sin(beam)^2
  __shared__ float inv_sizes[4];         // 1 / size of each level
  __shared__ float w1s[9][kKeysRows];    // warp 2's sandwich, for warp 3's sum
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // Replica blockIdx.y: its par row, its rows, its tables.
  const int rep = blockIdx.y;
  par += 64 * rep;
  const int row = blockIdx.x * kKeysRows + lane;
  const bool live = row < rpr;
  const int c = rep * rpr + (live ? row : rpr - 1);

  // The row's inputs are loaded ahead of the barrier.
  const float px = pts[0 * C + c], py = pts[1 * C + c], pz = pts[2 * C + c];
  float r[9], tb[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) r[i] = rb[i * C + c];
#pragma unroll
  for (int i = 0; i < 3; ++i) tb[i] = warp < 2 ? pb[i * C + c] : 0.f;
  if (threadIdx.x < 64) sp[threadIdx.x] = par[threadIdx.x];
  if (threadIdx.x == 64) {
    const float tsd = sinf(par[P_BEAM] * kDeg2Rad);
    tangent_var = tsd * tsd;
  }
  if (threadIdx.x >= 96 && threadIdx.x < 96 + levels) inv_sizes[threadIdx.x - 96] = 1.0f / par[P_SIZES + threadIdx.x - 96];
  __syncthreads();
  const float* e = sp + P_EXT_R;

  float w2[9];
  if (warp < 2) {
    // p_i = ext_r p + ext_t ; p_w = R_b p_i + t_b   (un-fused: they decide the keys)
    float pi[3], pw[3];
    p_lidar_to_imu(e, sp + P_EXT_T, px, py, pz, pi);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      pw[i] = LK_ADD(LK_ADD(LK_ADD(LK_MUL(r[3 * i], pi[0]), LK_MUL(r[3 * i + 1], pi[1])), LK_MUL(r[3 * i + 2], pi[2])), tb[i]);
    if (warp == 0 && live) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        piw[i * C + c] = pi[i];
        piw[(3 + i) * C + c] = pw[i];
      }
    }
    // Own (chain 0, warp 0) or neighbour (chain 1, warp 1) keys, centres and probe starts.
    const int chain = warp;
    for (int lvl = 0; lvl < levels; ++lvl) {
      const int m = chain * levels + lvl;
      const float size = sp[P_SIZES + lvl];
      const float inv_size = inv_sizes[lvl];
      float ks[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        ks[i] = floorf(LK_MUL(pw[i], inv_size));
        if (chain == 1) {
          const float quarter = LK_MUL(size, 0.25f);
          const float rel = LK_SUB(pw[i], LK_MUL(LK_ADD(ks[i], 0.5f), size));
          ks[i] = LK_ADD(ks[i], (rel > quarter ? 1.0f : 0.0f) - (rel < -quarter ? 1.0f : 0.0f));
        }
      }
      uint32_t h = 0;
      const uint32_t prime[3] = {73856093u, 471943u, 83492791u};
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int ki = static_cast<int>(ks[i]);
        if (live) {
          keys[(3 * m + i) * C + c] = ki;
          vc[(3 * m + i) * C + c] = LK_MUL(LK_ADD(ks[i], 0.5f), size);
        }
        h ^= static_cast<uint32_t>(ki) * prime[i];
      }
      if (live)
        idx0[m * C + c] = static_cast<int>(h & static_cast<uint32_t>(capacity - 1)) + (rep * levels + lvl) * capacity;
    }
  } else if (warp == 2) {
    // Sensor covariance in the LiDAR frame (calcBodyCov, voxel_map.cc:22-40).
    const float zsafe = fabsf(pz) < 1e-8f ? 1e-4f : pz;
    const float rng = sqrtf(px * px + py * py + zsafe * zsafe);
    const float inv_rng = 1.0f / fmaxf(rng, 1e-12f);
    const float dx = px * inv_rng, dy = py * inv_rng, dz = zsafe * inv_rng;
    const float dept = sp[P_DEPT];
    const float range_var = dept * dept;
    float b1z = -(dx + dy) / (fabsf(dz) < 1e-12f ? 1e-12f : dz);
    const float n1 = 1.0f / sqrtf(1.0f + 1.0f + b1z * b1z);
    const float b1x = n1, b1y = n1;
    b1z = b1z * n1;
    const float c2x = b1y * dz - b1z * dy, c2y = b1z * dx - b1x * dz, c2z = b1x * dy - b1y * dx;
    const float n2 = 1.0f / sqrtf(fmaxf(c2x * c2x + c2y * c2y + c2z * c2z, 1e-24f));
    const float b2x = c2x * n2, b2y = c2y * n2, b2z = c2z * n2;
    const float a[3][2] = {
        {rng * (-dz * b1y + dy * b1z), rng * (-dz * b2y + dy * b2z)},
        {rng * (dz * b1x - dx * b1z), rng * (dz * b2x - dx * b2z)},
        {rng * (-dy * b1x + dx * b1y), rng * (-dy * b2x + dx * b2y)},
    };
    const float d3[3] = {dx, dy, dz};
    float bc[9];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        bc[3 * i + j] = range_var * d3[i] * d3[j] + tangent_var * (a[i][0] * a[j][0] + a[i][1] * a[j][1]);
    // (R_b E) bc (R_b E)^T
    float re[9], w1[9];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        re[3 * i + j] = r[3 * i + 0] * e[0 + j] + r[3 * i + 1] * e[3 + j] + r[3 * i + 2] * e[6 + j];
    sandwich(re, bc, w1);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      w1s[k][lane] = w1[k];
      if (live) {
        covs[(9 + k) * C + c] = w1[k];
        covs[(18 + k) * C + c] = bc[k];
      }
    }
  } else {
    // (R_b [p_i]x) C_rr (R_b [p_i]x)^T
    float pi[3];
    p_lidar_to_imu(e, sp + P_EXT_T, px, py, pz, pi);
    const float sk[9] = {0.f, -pi[2], pi[1], pi[2], 0.f, -pi[0], -pi[1], pi[0], 0.f};
    float rc[9];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        rc[3 * i + j] = r[3 * i + 0] * sk[0 + j] + r[3 * i + 1] * sk[3 + j] + r[3 * i + 2] * sk[6 + j];
    sandwich(rc, sp + P_COV_RR, w2);
  }
  __syncthreads();
  if (warp == 3 && live) {
#pragma unroll
    for (int k = 0; k < 9; ++k) covs[k * C + c] = w1s[k][lane] + w2[k] + sp[P_COV_PP + k];
  }
}

__device__ __forceinline__ float nwn(const float n[3], const float w[9]) {
  float out = n[0] * w[0] * n[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) out = out + n[k / 3] * w[k] * n[k % 3];
  return out;
}

// ---------------------------------------------------------------- select --
//
// One launch a call.  Blocks 0..NB-1 each own one bucket: the block gathers
// its bucket's rows in ascending row order (an ordered ballot/popc scan over
// bidx), runs the row pass on them in groups of at most kGroup rows, writes
// their 46 outputs, and sums s40 and the match count over exactly those
// rows.  Blocks NB.. each cover kOrphanSpan rows and run the row pass only,
// on the rows that belong to no bucket (bidx outside [0, NB): the padding).
// A bucket is the integer part of bidx (truncated, as the plain version's
// int64 cast), so every row is written by exactly one block.
//
// Row pass, 64 rows a round, in two steps:
// - candidates: thread t takes candidate m = t / 64 (= chain * L + level,
//   m < 2L) of row t % 64, so a warp reads 32 rows of one plane column at
//   once; it computes the candidate's gates, sig, prob and sl and leaves
//   them in shared memory;
// - selection: eight lanes a row, lane q reading candidate q's record.
//   reachable is the product of the earlier levels' found * (1 - isp), read
//   by shuffles in level order; each chain's pick is the first level of
//   largest prob among those with ok > 0.5 (prob > best_prob taken in level
//   order, as select_plain does).  The row's 40 features (lane q the
//   features q + 8t, from a code a feature), the features times w, and its
//   matched, w and r_meas go to shared memory; the outputs are written from
//   there, a warp a component, consecutive lanes on consecutive rows.
//
// Sums: thread t < 55 owns a 4x4 tile of the upper triangle of the 40x40,
// reads each row's feature quads as float4 (x_i w from the row pass) and
// accumulates each entry in ascending row order as fma(x_i * w, x_j, s) --
// the sequential order, so s40 is deterministic without atomics -- and
// mirrors the tile on the store.  Warp kCountWarp counts the bucket's matched
// rows (nm; a lane a strided subset, then a fixed shuffle tree); the other
// warps write the outputs meanwhile.
//
// Bound on the H100: per bucket ~121 rows of ~230 floats in (~110 KB) and 46
// out, and 820 FMAs a row for the sums: far below the card's rates.  What
// bounds it is one block's chain of steps (tools/select_phases.py counts the
// cycles of each): the bidx scan (one round of loads), two row-pass rounds
// at main-path sizes, and the sums, row after row from shared memory.

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kLanesPerRow = 8;                       // one lane a candidate, 2L <= 8
constexpr int kRowsPerPass = kThreads / kLanesPerRow;  // 64
constexpr int kGroup = 256;                           // rows staged in shared memory at once
constexpr int kScanPerThread = 8;                     // bidx words a thread reads a scan step
constexpr int kScanStep = kThreads * kScanPerThread;  // 4,096 rows
constexpr int kOrphanSpan = kRowsPerPass;             // rows an orphan block covers: one round
constexpr int kXStride = 44;   // floats a staged feature row: a multiple of 4 for float4
constexpr int kTiles = 55;     // 4x4 tiles of the upper triangle: 10 * 11 / 2
constexpr int kCountWarp = 2;  // first warp without a tile
constexpr int kCandStride = 68;  // 68 = 4 (mod 32): a warp's 8 candidates x 4 rows on 32 banks
constexpr int kCandFields = 11;  // found, isp, ok without reachable, prob, sl, n (3), centre (3)

struct SelectShared {
  float x[kGroup * kXStride];   // the group's features, a row each
  float xw[kGroup * kXStride];  // the same times the row's w
  float cand[kCandFields][8 * kCandStride];  // a round's candidates: [field][m * kCandStride + row]
  float matched[kGroup], w[kGroup], r[kGroup];
  int rows[kGroup];                      // the group's rows, ascending
  int cnt[kScanPerThread * kWarps];      // a scan step's counts, (word, warp) order
  int step_total;
};

struct SelectArgs {
  const float *par, *piw, *bcov, *vcs, *plane, *flags, *mask;  // par: a row of 8 a replica
  float* out;
  int C, levels, rpr;  // rpr: rows a replica
};

// Candidate m of row c: found, isp, found * isp * gates, prob, sl, n, centre.
__device__ __forceinline__ void select_candidate(const SelectArgs& a, float* rec, int m, int c) {
  constexpr int F = 8 * kCandStride;  // a field's stride in sh.cand
  const int C = a.C, nc = 2 * a.levels;
  const float* par = a.par + 8 * (c / a.rpr);  // the row's replica
  const float sigma_num = par[0], radius_k = par[1];
  float pw[3], wc[9], cen[3], n3[3], pv[21];
  const float* pr = a.plane + static_cast<size_t>(m) * 31 * C + c;  // column k at pr[k * C]
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    pw[k] = __ldg(a.piw + (3 + k) * C + c);
    cen[k] = __ldg(a.vcs + (3 * m + k) * C + c) + __ldg(pr + k * C);
    n3[k] = __ldg(pr + (3 + k) * C);
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) wc[k] = __ldg(a.bcov + k * C + c);
#pragma unroll
  for (int k = 0; k < 21; ++k) pv[k] = __ldg(pr + (10 + k) * C);  // 6x6 plane covariance, upper
  const float found = __ldg(a.flags + m * C + c);
  const float isp = __ldg(a.flags + (nc + m) * C + c);
  const float radius = __ldg(pr + 9 * C);
  const float rel[3] = {pw[0] - cen[0], pw[1] - cen[1], pw[2] - cen[2]};
  const float sdist = n3[0] * rel[0] + n3[1] * rel[1] + n3[2] * rel[2];
  const float dist = fabsf(sdist);
  const float d2c = rel[0] * rel[0] + rel[1] * rel[1] + rel[2] * rel[2];
  const float range_dis2 = fmaxf(d2c - dist * dist, 0.f);
  const float rk = radius_k * radius;
  const float gate_range = range_dis2 <= rk * rk ? 1.f : 0.f;
  // sigma_l = j^T plane_var j + n^T W n, j = [rel, -n]; PSD clamp at 1e-12.
  const float j6[6] = {rel[0], rel[1], rel[2], -n3[0], -n3[1], -n3[2]};
  float sig = 0.f;
#pragma unroll
  for (int ii = 0; ii < 6; ++ii) {
    float row = 0.f;
#pragma unroll
    for (int jj = 0; jj < 6; ++jj) row = row + pv[sym21(ii, jj)] * j6[jj];
    sig = sig + j6[ii] * row;
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) sig = sig + n3[k / 3] * wc[k] * n3[k % 3];
  sig = fmaxf(sig, 1e-12f);
  const float gate_sigma = dist < sigma_num * sqrtf(sig) ? 1.f : 0.f;
  rec[0 * F] = found;
  rec[1 * F] = isp;
  rec[2 * F] = found * isp * gate_range * gate_sigma;
  rec[3 * F] = rsqrtf(sig) * expf(-0.5f * dist * dist / sig);
  rec[4 * F] = sig - nwn(n3, wc);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    rec[(5 + k) * F] = n3[k];
    rec[(8 + k) * F] = cen[k];
  }
}

// Feature f of a row as a code: n[a] (bits 0-1) times p[b] (bits 2-3),
// negated (kFeatNeg), or times 0 (kFeatZero) or 1 (kFeatOne); or n . c
// (kFeatDot).  The 40 features: mt (27) = n_a [p]x_{i,b} at 9i + 3a + b with
// [p]x = {{0, -p2, p1}, {p2, 0, -p0}, {-p1, p0, 0}}, n (3), n_a p_b (9) at
// 30 + 3a + b, n . c (1).  The codes of features 8t..8t + 7 are the bytes of
// word t of kFeatCodes in select_rows, feature 8t + q in byte q:
//   f  0-8:  32 24  4 33 25  5 34 26  6    f  9-17:  8 32 16  9 33 17 10 34 18
//   f 18-26: 20  0 32 21  1 33 22  2 34    f 27-29: 64 65 66
//   f 30-38:  0  4  8  1  5  9  2  6 10    f 39: 128
constexpr int kFeatNeg = 16, kFeatZero = 32, kFeatOne = 64, kFeatDot = 128;

// The row pass over sh.rows[0..n_rows), 64 rows a round.
__device__ void select_rows(const SelectArgs& a, SelectShared& sh, int n_rows) {
  constexpr int F = 8 * kCandStride;
  const int lane = threadIdx.x & 31, q = lane & 7;
  const int C = a.C, levels = a.levels, nc = 2 * levels;
  const bool cand = q < nc;
  const int chain = cand && q >= levels ? 1 : 0;
  const int lvl = cand ? q - chain * levels : 0;
  constexpr unsigned long long kFeatCodes[5] = {0x1a22051921041820ull, 0x0a11210910200806ull,
                                                0x2101152000141222ull, 0x0400424140220216ull,
                                                0x800a060209050108ull};
  int feat[5];  // lane q's features q + 8t
#pragma unroll
  for (int t = 0; t < 5; ++t) feat[t] = static_cast<int>(kFeatCodes[t] >> (8 * q) & 0xffu);
  for (int i0 = 0; i0 < n_rows; i0 += kRowsPerPass) {
    if (i0 > 0) __syncthreads();  // the last round's records are read
    // The selection step's own inputs, loaded first so that their latency
    // runs under the candidate step.
    const int i = static_cast<int>(threadIdx.x) / kLanesPerRow;
    const bool live = i0 + i < n_rows;
    const int c = sh.rows[live ? i0 + i : n_rows - 1];  // a spare group repeats a row, unstored
    float ws[9], p[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) p[k] = __ldg(a.piw + k * C + c);
#pragma unroll
    for (int k = 0; k < 9; ++k) ws[k] = __ldg(a.bcov + (9 + k) * C + c);
    const float row_mask = __ldg(a.mask + c);
    const float ratio = a.par[8 * (c / a.rpr) + 2];
    {
      const int m = threadIdx.x / kRowsPerPass, ic = threadIdx.x % kRowsPerPass;
      if (m < nc && i0 + ic < n_rows) select_candidate(a, &sh.cand[0][m * kCandStride + ic], m, sh.rows[i0 + ic]);
    }
    __syncthreads();

    const float* rec = &sh.cand[0][q * kCandStride + i];
    const float found = cand ? rec[0 * F] : 0.f, isp = cand ? rec[1 * F] : 0.f;
    const float ok0 = cand ? rec[2 * F] : 0.f, prob = cand ? rec[3 * F] : 0.f;
    const float sl = cand ? rec[4 * F] : 0.f;
    float n3[3], cen[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      n3[k] = cand ? rec[(5 + k) * F] : 0.f;
      cen[k] = cand ? rec[(8 + k) * F] : 0.f;
    }
    // reachable = prod over the chain's earlier levels of found * (1 - isp).
    float reachable = 1.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (k + 1 >= levels) break;  // levels is the same in every lane
      const float fk = __shfl_sync(kFull, found, chain * levels + k, kLanesPerRow);
      const float ik = __shfl_sync(kFull, isp, chain * levels + k, kLanesPerRow);
      if (k < lvl) reachable = reachable * fk * (1.f - ik);
    }
    const float ok = ok0 * reachable;
    // Each chain's pick: prob > best_prob in level order, among ok > 0.5.
    float ch_matched[2];
    int ch_pick[2];
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
      float best_prob = -3.0e38f, b_matched = 0.f;
      int pick = -1;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k >= levels) break;
        const float ok_k = __shfl_sync(kFull, ok, ch * levels + k, kLanesPerRow);
        const float prob_k = __shfl_sync(kFull, prob, ch * levels + k, kLanesPerRow);
        if (ok_k > 0.5f && prob_k > best_prob) {
          best_prob = prob_k;
          pick = k;
        }
        b_matched = fmaxf(b_matched, ok_k);
      }
      ch_matched[ch] = b_matched;
      ch_pick[ch] = pick;
    }
    const int sel = ((1.f - ch_matched[0]) * ch_matched[1]) > 0.5f ? 1 : 0;
    const float matched = fmaxf(ch_matched[0], ch_matched[1]) * row_mask;
    const int pick = sel ? ch_pick[1] : ch_pick[0];
    const int src = pick < 0 ? 0 : sel * levels + pick;
    float n[3], cc[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      n[k] = __shfl_sync(kFull, n3[k], src, kLanesPerRow);
      cc[k] = __shfl_sync(kFull, cen[k], src, kLanesPerRow);
    }
    float s_l = __shfl_sync(kFull, sl, src, kLanesPerRow);
    if (pick < 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) n[k] = cc[k] = 0.f;
      s_l = 0.f;
    }
    if (!live) continue;  // after the last shuffle
    const float r_meas = ratio * (s_l + nwn(n, ws));
    const float w = matched / (r_meas + kRJitter);
    if (q == 0) {
      sh.matched[i0 + i] = matched;
      sh.w[i0 + i] = w;
      sh.r[i0 + i] = r_meas;
    }
    // Lane q stores features f = q + 8t, each n[a] times its factor (or n.c).
    const float ndotc = n[0] * cc[0] + n[1] * cc[1] + n[2] * cc[2];
    float* xr = sh.x + (i0 + i) * kXStride;
    float* xwr = sh.xw + (i0 + i) * kXStride;
#pragma unroll
    for (int t = 0; t < 5; ++t) {
      const int fc = feat[t];
      const int fa = fc & 3, fp = (fc >> 2) & 3;
      const float na = fa == 0 ? n[0] : fa == 1 ? n[1] : n[2];
      const float pv = fp == 0 ? p[0] : fp == 1 ? p[1] : p[2];
      const float factor = fc & kFeatOne ? 1.f : fc & kFeatZero ? 0.f : fc & kFeatNeg ? -pv : pv;
      const float v = fc & kFeatDot ? ndotc : na * factor;
      xr[q + 8 * t] = v;
      xwr[q + 8 * t] = v * w;
    }
  }
}

// One bucket's (or one orphan span's) rows: see the comment above.
__global__ void __launch_bounds__(kThreads, 1)
select_kernel(SelectArgs a, const float* __restrict__ bidx, float* __restrict__ s40,
              float* __restrict__ nm, int n_buckets, int nb_rep) {
  extern __shared__ __align__(16) unsigned char select_smem[];
  SelectShared& sh = *reinterpret_cast<SelectShared*>(select_smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = a.C;
  const int b = blockIdx.x;
  const bool bucket_block = b < n_buckets;
  // A bucket's rows lie among its replica's rows; an orphan block takes a
  // span of all the rows.
  const int lo = bucket_block ? (b / nb_rep) * a.rpr : (b - n_buckets) * kOrphanSpan;
  const int hi = min(C, lo + (bucket_block ? a.rpr : kOrphanSpan));
  const float f_nb = static_cast<float>(n_buckets);

  // This thread's sums tile (rows 4ta..4ta + 3, columns 4tb..4tb + 3), ta <= tb.
  int ta = -1, tb = -1;
  if (bucket_block && tid < kTiles) {
    int e = tid;
    ta = 0;
    while (e >= 10 - ta) { e -= 10 - ta; ++ta; }
    tb = ta + e;
  }
  float acc[4][4] = {}, count = 0.f;

  // Process sh.rows[0..n_rows): row pass, then outputs, sums and count side by side.
  auto process = [&](int n_rows) {
    select_rows(a, sh, n_rows);
    __syncthreads();
    if (bucket_block && ta >= 0) {
      const float4* xa = reinterpret_cast<const float4*>(sh.xw + 4 * ta);
      const float4* xb = reinterpret_cast<const float4*>(sh.x + 4 * tb);
      constexpr int kRow4 = kXStride / 4;
#pragma unroll 4
      for (int i = 0; i < n_rows; ++i) {
        const float4 u4 = xa[i * kRow4], v4 = xb[i * kRow4];
        const float u[4] = {u4.x, u4.y, u4.z, u4.w}, v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(u[r], v[q], acc[r][q]);
      }
    } else if (bucket_block && warp == kCountWarp) {  // lanes over strided rows, then a fixed tree
      float part = 0.f;
      for (int i = lane; i < n_rows; i += 32) part += sh.matched[i];
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) part += __shfl_xor_sync(kFull, part, d);
      count = count + part;
    } else if (!bucket_block || warp > kCountWarp) {  // the outputs: a warp a component
      const int first = bucket_block ? kCountWarp + 1 : 0;
      int rr[kGroup / 32];  // this lane's rows: lane, lane + 32, ...
#pragma unroll
      for (int j = 0; j < kGroup / 32; ++j) rr[j] = lane + 32 * j < n_rows ? sh.rows[lane + 32 * j] : -1;
      for (int k = warp - first; k < 46; k += kWarps - first) {
        const float* src = k >= 6 ? sh.x + k - 6 : k == 1 ? sh.w : k == 2 ? sh.r : sh.matched;
        const int stride = k >= 6 ? kXStride : 1;
        const bool zero = k == 4 || k == 5;
        float* dst = a.out + static_cast<size_t>(k) * C;
#pragma unroll
        for (int j = 0; j < kGroup / 32; ++j)
          if (rr[j] >= 0) dst[rr[j]] = zero ? 0.f : src[(lane + 32 * j) * stride];
      }
    }
    __syncthreads();
  };

  // Gather the block's rows in ascending order, kScanStep rows of bidx a step;
  // a group is processed as soon as it holds kGroup rows.
  int total = 0, done = 0;
  for (int base = lo; base < hi; base += kScanStep) {
    float v[kScanPerThread];
#pragma unroll
    for (int j = 0; j < kScanPerThread; ++j) {
      const int r = base + j * kThreads + tid;
      v[j] = r < hi ? __ldg(bidx + r) : -1.f;
    }
    unsigned bal[kScanPerThread], mine = 0u;
#pragma unroll
    for (int j = 0; j < kScanPerThread; ++j) {
      const int r = base + j * kThreads + tid;
      const bool in = v[j] > -1.f && v[j] < f_nb;  // NaN is in no bucket
      const bool f = r < hi && (bucket_block ? in && static_cast<int>(v[j]) == b : !in);
      bal[j] = __ballot_sync(kFull, f);
      mine |= (f ? 1u : 0u) << j;
    }
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < kScanPerThread; ++j) sh.cnt[j * kWarps + warp] = __popc(bal[j]);
    }
    __syncthreads();
    if (warp == 0) {  // exclusive scan of the 128 counts, four a lane
      static_assert(kScanPerThread * kWarps == 4 * 32, "four counts a lane");
      int c4[4], s = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        c4[k] = sh.cnt[4 * lane + k];
        s += c4[k];
      }
      int incl = s;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += y;
      }
      int ex = incl - s;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        sh.cnt[4 * lane + k] = ex;
        ex += c4[k];
      }
      if (lane == 31) sh.step_total = incl;
    }
    __syncthreads();
    const int end = total + sh.step_total;
    const unsigned lt = (1u << lane) - 1u;
    int pos[kScanPerThread];
#pragma unroll
    for (int j = 0; j < kScanPerThread; ++j)
      pos[j] = total + sh.cnt[j * kWarps + warp] + __popc(bal[j] & lt);
    for (;;) {
#pragma unroll
      for (int j = 0; j < kScanPerThread; ++j) {
        const int slot = pos[j] - done;
        if ((mine >> j & 1u) && slot >= 0 && slot < kGroup) sh.rows[slot] = base + j * kThreads + tid;
      }
      if (end - done < kGroup) break;
      __syncthreads();
      process(kGroup);
      done += kGroup;
    }
    total = end;
    __syncthreads();  // the next step rewrites sh.cnt
  }
  if (total > done) process(total - done);

  if (!bucket_block) return;
  if (ta >= 0) {  // entries i <= j, mirrored; a diagonal tile's lower half is not stored
    float* sb = s40 + static_cast<size_t>(b) * 1600;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 4 * ta + r, j = 4 * tb + q;
        if (i <= j) {
          sb[i * 40 + j] = acc[r][q];
          sb[j * 40 + i] = acc[r][q];
        }
      }
  } else if (warp == kCountWarp) {
#pragma unroll
    for (int k = 0; k < 4; ++k) nm[b * 128 + 32 * k + lane] = count;
  }
}

}  // namespace

// batch replicas of C / batch rows each (par [batch, 64]).
LK_API int keys_launch(const float* par, const float* pts, const float* rb, const float* pb,
                       float* piw, float* covs, int* keys, float* vc, int* idx0, int C, int levels,
                       int capacity, int batch, void* stream) {
  if (C <= 0 || batch <= 0) return 0;
  const int rpr = C / batch;
  const dim3 grid(lk_blocks(rpr, kKeysRows), batch);
  keys_kernel<<<grid, kKeysThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      par, pts, rb, pb, piw, covs, keys, vc, idx0, C, levels, capacity, rpr);
  return static_cast<int>(cudaGetLastError());
}

LK_API int select_launch(const float* par, const float* piw, const float* bcov, const float* vc,
                         const float* plane, const float* flags, const float* mask,
                         const float* bidx, float* out, float* s40, float* nm, int C, int levels,
                         int n_buckets, int batch, void* stream) {
  if (batch <= 0) return 0;
  const int grid = n_buckets + lk_blocks(C, kOrphanSpan);
  if (grid <= 0) return 0;
  constexpr int smem = static_cast<int>(sizeof(SelectShared));  // above 48 KB: the opt-in
  const cudaError_t e = cudaFuncSetAttribute(select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const SelectArgs a{par, piw, bcov, vc, plane, flags, mask, out, C, levels, C / batch};
  select_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a, bidx, s40, nm, n_buckets,
                                                                             n_buckets / batch);
  return static_cast<int>(cudaGetLastError());
}
