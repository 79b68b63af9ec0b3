// Voxel-map plane refit over the refit slots of one insert, for sm_90a.
//
// Replaces the JAX package's Pallas kernel _fit_kernel
// (legkilo_tpu/ops/pallas/plane_fit_rows.py:122, driven by fit_rows_call
// :295) and computes what it computes, for each refit slot b, from the map's
// own tables read at row fs[b] (ops/plane_fit_rows.fit_slots_call):
//
//   par    [8]        planer_threshold at [0]
//   meta_x [M, 4]     n, new_n, initialized, is_plane      (f32)
//   mom_x  [M, 9]     m1(3) m2(6)                          (f32)
//   moms_x [M, 60]    s0(6) s1(18) s2(36)     (storage dtype: f32, f16, bf16)
//   fs     [B]        int64 rows; the zero sentinel row for an unfilled slot
//                     (a row outside [0, M) traps the kernel)
//   out    [B, 35]    centre_rel(3) normal(3) evals(3) radius(1)
//                     plane_var(21) | n, 0, 1, is_plane
//
// Per slot: covariance from the moments, the closed-form eigenvalues of the
// symmetric 3x3 (trigonometric form, acos by the Abramowitz-Stegun 4.4.46
// polynomial as in ops/eig3x3.py), eigenvectors from row crosses with the
// rank-1 and zero-matrix fallbacks, and the 6x6 plane-parameter covariance
// contracted from s0/s1/s2.
//
// Every branch here hangs on an ulp (cov = m2/n - c c^T cancels; the
// `diagonal`, arg-max, `good`, `ok`, |denom| and lam_min < threshold
// tests), so all arithmetic is on lk::F (lk_exact.cuh): no FMA contraction,
// and the order of operations of ops/plane_fit_rows.fit_rows_plain.
//
// The first port ran a thread a slot on the JAX layout ([69, B] gathered and
// transposed by eight launches of glue in front of it) in blocks of 64: 16
// blocks at B = 1024, and each thread ran the whole ~1.6 k-op chain alone.
// Here a block takes eight slots with three warps, so B = 1024 is 128
// blocks over the card's 132 SMs:
//
//   * the eigen warp: two lanes a slot read the 16 values the eigen part
//     needs straight from the tables and run it (~320 ops, a chain of
//     square roots, divisions and two cosines; the pair splits the two
//     cosines, the two eigenvectors and the two alpha_k / b_k between
//     them, so the warp, bound by its issue, runs each once), then hand the
//     eigenvectors and the scalars of the contraction over in shared memory
//     at the block's one barrier and write the row's values that need no
//     contraction;
//   * two contraction warps, eight lanes a slot: the lanes load the slot's
//     70 floats into shared memory (moms converted to f32 on load, which is
//     exact) and compute t (54 values) while the eigen warp works; after the
//     barrier w (18) and u (6), then c (4), then t_nn / t_nq (15), a phase a
//     __syncwarp, values exchanged in shared memory.  Each value is computed
//     whole by one lane in fit_rows_plain's order, so the split decides who
//     computes a value, never its order of summation, and the outputs stay
//     bit-equal to the thread-a-slot kernel's.
//
// Bound on the H100 at the main path's B = 1024: it reads fs (8 B a slot),
// n and the 69 moments of each distinct row fs names once (280 B in f32;
// 641 rows in chip_smoke's fit_inputs, whose unfilled slots share the
// sentinel row) and writes 35 floats a slot (140 B): 331 KB, 0.10 us at
// 3.35 TB/s; ~1.6 k flops a slot.  Launch latency and the eigen
// part's dependent chain dominate.

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "lk_common.cuh"
#include "lk_exact.cuh"

namespace {

using lk::F;
using lk::sel;

constexpr float kEps = 1e-12f;       // ops/eig3x3._EPS
constexpr float kAlphaEps = 1e-7f;   // core/plane_fit._ALPHA_EPS
constexpr float kPi = 3.14159265358979323846f;
// Divisions by a constant are products with its reciprocal, as in fit_rows_plain.
constexpr float kThird = (float)(1.0 / 3.0);
constexpr float kSixth = (float)(1.0 / 6.0);
constexpr float kTwoPiThird = (float)(2.0 * 3.14159265358979323846 / 3.0);

// Index of (i, j) in the packed upper triangle (0,0) (0,1) (0,2) (1,1) (1,2) (2,2).
__host__ __device__ constexpr int sym6(int i, int j) {
  const int a = i < j ? i : j, b = i < j ? j : i;
  return a * (5 - a) / 2 + b;  // branch-free where i, j are run-time values
}

__device__ __forceinline__ void cross(const F a[3], const F b[3], F o[3]) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ F dot(const F a[3], const F b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ F acos_poly(F x) {
  const float c[8] = {1.5707963050f, -0.2145988016f, 0.0889789874f, -0.0501743046f,
                      0.0308918810f, -0.0170881256f, 0.0066700901f, -0.0012624911f};
  const F ax = lk::fmin(lk::fmax(lk::fabs(x), F(0.f)), F(1.f));
  F poly(c[7]);
#pragma unroll
  for (int k = 6; k >= 0; --k) poly = poly * ax + F(c[k]);
  const F a = lk::fsqrt(lk::fmax(F(1.f) - ax, F(0.f))) * poly;
  return sel(x < F(0.f), F(kPi) - a, a);
}

// Unit vector orthogonal to unit vector v.
__device__ __forceinline__ void any_orthogonal(const F v[3], F o[3]) {
  const bool use_x = lk::fabs(v[0]) < F(0.9f);
  const F base[3] = {F(use_x ? 1.f : 0.f), F(use_x ? 0.f : 1.f), F(0.f)};
  F w[3];
  cross(v, base, w);
  const F nrm = lk::fsqrt(lk::fmax(dot(w, w), F(0.f)));
  const F inv = F(1.f) / lk::fmax(nrm, F(kEps));
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = w[i] * inv;
}

// Unit eigenvector of symmetric cov for eigenvalue lam: the largest cross
// of two rows of (cov - lam I); a rank-1 matrix falls back to a vector
// orthogonal to its largest row, the zero matrix to (1, 0, 0).
__device__ __forceinline__ void eigvec(const F cov[3][3], F lam, F o[3]) {
  F m[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) m[i][j] = i == j ? cov[i][j] - lam : cov[i][j];
  F c0[3], c1[3], c2[3];
  cross(m[0], m[1], c0);
  cross(m[0], m[2], c1);
  cross(m[1], m[2], c2);
  const F n0 = dot(c0, c0), n1 = dot(c1, c1), n2 = dot(c2, c2);
  const bool pick0 = (n0 >= n1) && (n0 >= n2);
  const bool pick1 = !pick0 && (n1 >= n2);
  F v[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) v[i] = sel(pick0, c0[i], sel(pick1, c1[i], c2[i]));
  const F nrm2 = dot(v, v);
  const F nrm = lk::fsqrt(lk::fmax(nrm2, F(0.f)));

  const F rn0 = dot(m[0], m[0]), rn1 = dot(m[1], m[1]), rn2 = dot(m[2], m[2]);
  const bool rp0 = (rn0 >= rn1) && (rn0 >= rn2);
  const bool rp1 = !rp0 && (rn1 >= rn2);
  F rbest[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) rbest[i] = sel(rp0, m[0][i], sel(rp1, m[1][i], m[2][i]));
  const F rbest_n = lk::fsqrt(lk::fmax(dot(rbest, rbest), F(0.f)));
  const F inv_rb = F(1.f) / lk::fmax(rbest_n, F(kEps));
  F runit[3], plane_fb[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) runit[i] = rbest[i] * inv_rb;
  any_orthogonal(runit, plane_fb);
  const bool has_row = rbest_n > F(kEps);
  const F fallback[3] = {sel(has_row, plane_fb[0], F(1.f)), sel(has_row, plane_fb[1], F(0.f)),
                         sel(has_row, plane_fb[2], F(0.f))};
  const F scale = lk::fmax(lk::fmax(rn0, lk::fmax(rn1, rn2)), F(kEps));
  const bool good = (nrm2 > F(1e-12f) * scale * scale) && (nrm > F(kEps));
  const F inv_n = F(1.f) / lk::fmax(nrm, F(kEps));
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = sel(good, v[i] * inv_n, fallback[i]);
}

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__half>(__half x) { return __half2float(x); }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) { return __bfloat162float(x); }

// Index of (r, c), r <= c, in the packed upper triangle of a 6x6.
__device__ __forceinline__ int tri6(int r, int c) { return r * (11 - r) / 2 + c; }

constexpr int kLanes = 8;                       // contraction lanes a slot
constexpr int kSlots = 8;                       // slots a block
constexpr int kThreads = 32 + kLanes * kSlots;  // the eigen warp, then two contraction warps
constexpr int kIn = 70;                         // m1 0:3 | m2 3:9 | s0 9:15 | s1 15:33 | s2 33:69 | n 69

// A slot's row and the values its eigen lane and its contraction lanes exchange.
struct SlotShared {
  float in[kIn];
  float bs[2][9];   // b_k[i][j] = e_k[i] v_min[j] + v_min[i] e_k[j]
  float e12[2][3];  // v_mid, v_max
  float alpha[2];
  float is_plane;
  float t[54];      // t[sym6(b, c)][d][a]
  float us[6];      // u_i[c]
  float w[2][9];    // w_j[b][a]
  float c[4];       // c_mat[i][j]
};

// The block's one barrier: the eigen warp's values are in shared memory.
__device__ __forceinline__ void eigen_done() { asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory"); }

// The eigen warp: lanes g and g + 8 take slot g of the block (lanes 16-31
// repeat lanes 0-15 and store nothing).  Each reads the 16 values it needs
// straight from the tables and runs the eigen part; where it has two like
// computations (the two cosines, the lam_min and lam_max eigenvectors, the
// two alpha_k and b_k) each lane of the pair runs one and a shuffle or
// shared memory swaps them, so the warp issues each once.  It hands the
// eigenvectors and the scalars the contraction needs over in shared memory,
// then lane g writes the row's values that need no contraction.
template <typename T>
__device__ __forceinline__ void eigen_lane(SlotShared* shared, const float* __restrict__ par,
                                           const float* __restrict__ meta, const float* __restrict__ mom,
                                           const T* __restrict__ moms, const long long* __restrict__ fs,
                                           float* __restrict__ out, int B, int M) {
  // The second lane of a pair computes cos(phi) and the lam_max
  // eigenvector, the first cos(phi + 2 pi / 3) and the lam_min one.
  const int g = threadIdx.x % kSlots;
  const bool second = (threadIdx.x / kSlots) & 1;
  const int slot = blockIdx.x * kSlots + g;
  const bool live = threadIdx.x < kSlots && slot < B;
  const long long row = fs[min(slot, B - 1)];
  if (lk_outside(row, M)) __trap();
  F in[15];
#pragma unroll
  for (int k = 0; k < 9; ++k) in[k] = F(mom[row * 9 + k]);
#pragma unroll
  for (int k = 0; k < 6; ++k) in[9 + k] = F(to_f32(moms[row * 60 + k]));
  auto mr = [&](int i) { return in[i]; };

  const F threshold(par[0]);
  const F n_raw(meta[row * 4]);
  const F n = lk::fmax(n_raw, F(1.f));
  const F inv_n = F(1.f) / n;
  F cr[3], s0[3][3], cov[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) cr[i] = mr(i) * inv_n;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) s0[i][j] = mr(9 + sym6(i, j));
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = i; j < 3; ++j) {
      cov[i][j] = mr(3 + sym6(i, j)) * inv_n - cr[i] * cr[j];
      cov[j][i] = cov[i][j];
    }

  // ---- eigenvalues ----
  const F p1s = cov[0][1] * cov[0][1] + cov[0][2] * cov[0][2] + cov[1][2] * cov[1][2];
  const F q = (cov[0][0] + cov[1][1] + cov[2][2]) * F(kThird);
  const F d0q = cov[0][0] - q, d1q = cov[1][1] - q, d2q = cov[2][2] - q;
  const F p2 = d0q * d0q + d1q * d1q + d2q * d2q + F(2.f) * p1s;
  const F p = lk::fsqrt(lk::fmax(p2 * F(kSixth), F(0.f)));
  const bool diagonal = p1s < F(kEps);
  const F p_safe = sel(p > F(kEps), p, F(1.f));
  const F inv_p = F(1.f) / p_safe;
  F b[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) b[i][j] = (i == j ? cov[i][j] - q : cov[i][j]) * inv_p;
  const F detb = b[0][0] * (b[1][1] * b[2][2] - b[1][2] * b[2][1]) -
                 b[0][1] * (b[1][0] * b[2][2] - b[1][2] * b[2][0]) +
                 b[0][2] * (b[1][0] * b[2][1] - b[1][1] * b[2][0]);
  const F r = lk::fmin(lk::fmax(detb * F(0.5f), F(-1.f)), F(1.f));
  const F phi = acos_poly(r) * F(kThird);
  const F c_own = lk::fcos(sel(second, phi, phi + F(kTwoPiThird)));
  const F c_other(__shfl_xor_sync(0xffffffffu, c_own.v, kSlots));
  const F e_max_t = q + F(2.f) * p * sel(second, c_own, c_other);
  const F e_min_t = q + F(2.f) * p * sel(second, c_other, c_own);
  const F e_mid_t = F(3.f) * q - e_max_t - e_min_t;

  const F d0 = cov[0][0], d1 = cov[1][1], d2 = cov[2][2];
  const F dmin = lk::fmin(lk::fmin(d0, d1), d2);
  const F dmax = lk::fmax(lk::fmax(d0, d1), d2);
  const F dmid = d0 + d1 + d2 - dmin - dmax;
  const F lam_min = sel(diagonal, dmin, e_min_t);
  const F lam_mid = sel(diagonal, dmid, e_mid_t);
  const F lam_max = sel(diagonal, dmax, e_max_t);

  // ---- eigenvectors ----
  F v_own[3], v_min[3], v_max[3], v_mid[3], fb[3];
  eigvec(cov, sel(second, lam_max, lam_min), v_own);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const F other(__shfl_xor_sync(0xffffffffu, v_own[i].v, kSlots));
    v_min[i] = sel(second, other, v_own[i]);
    v_max[i] = sel(second, v_own[i], other);
  }
  const F dt = dot(v_min, v_max);
#pragma unroll
  for (int i = 0; i < 3; ++i) v_max[i] = v_max[i] - dt * v_min[i];
  const F nrm = lk::fsqrt(lk::fmax(dot(v_max, v_max), F(0.f)));
  any_orthogonal(v_min, fb);
  const F inv = F(1.f) / lk::fmax(nrm, F(kEps));
  const bool ok = nrm > F(1e-4f);
#pragma unroll
  for (int i = 0; i < 3; ++i) v_max[i] = sel(ok, v_max[i] * inv, fb[i]);
  cross(v_max, v_min, v_mid);
  const F is_plane_f(lam_min < threshold ? 1.f : 0.f);

  if (threadIdx.x < 2 * kSlots) {
    // Lane g hands over e_0 = v_mid, lane g + 8 e_1 = v_max: alpha_k, e_k
    // and b_k[i][j] = e_k[i] v_min[j] + v_min[i] e_k[j].
    SlotShared& S = shared[g];
    const int k = second;
    F e[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) e[i] = sel(second, v_max[i], v_mid[i]);
    F denom = n * (lam_min - sel(second, lam_max, lam_mid));
    denom = sel(lk::fabs(denom) < F(kAlphaEps), F(-kAlphaEps), denom);
    S.alpha[k] = (F(1.f) / denom).v;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      S.e12[k][i] = e[i].v;
#pragma unroll
      for (int j = 0; j < 3; ++j) S.bs[k][3 * i + j] = (e[i] * v_min[j] + v_min[i] * e[j]).v;
    }
    if (!second) S.is_plane = is_plane_f.v;
  }
  eigen_done();
  if (!live) return;
  // The head, s0 / n^2 (the plane_var block below the contraction's) and
  // the meta row.
  float* o = out + (long long)slot * 35;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    o[i] = cr[i].v;
    o[3 + i] = v_min[i].v;
  }
  o[6] = lam_min.v;
  o[7] = lam_mid.v;
  o[8] = lam_max.v;
  o[9] = lk::fsqrt(lk::fmax(lam_max, F(0.f))).v;
  const F inv_n2 = inv_n * inv_n;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = i; j < 3; ++j) o[10 + tri6(3 + i, 3 + j)] = (s0[i][j] * inv_n2 * is_plane_f).v;
  o[31] = n_raw.v;
  o[32] = 0.f;
  o[33] = 1.f;
  o[34] = is_plane_f.v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fit_slots_kernel(const float* __restrict__ par, const float* __restrict__ meta,
                     const float* __restrict__ mom, const T* __restrict__ moms,
                     const long long* __restrict__ fs, float* __restrict__ out, int B, int M) {
  __shared__ SlotShared shared[kSlots];
  if (threadIdx.x < 32) {
    eigen_lane(shared, par, meta, mom, moms, fs, out, B, M);
    return;
  }
  // ---- the contraction warps: eight lanes a slot ----
  const int sub = (threadIdx.x - 32) % kLanes;
  SlotShared& S = shared[(threadIdx.x - 32) / kLanes];
  const int slot = blockIdx.x * kSlots + (threadIdx.x - 32) / kLanes;
  const bool live = slot < B;  // a dead slot of the last block computes slot B - 1 and stores nothing
  const long long row = fs[min(slot, B - 1)];
  if (lk_outside(row, M)) __trap();

  // Every load of the slot's row in flight at once, then into shared memory.
  constexpr int kLoads = (kIn + kLanes - 1) / kLanes;
  float v[kLoads];
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int k = sub + kLanes * j;
    v[j] = k < 9 ? mom[row * 9 + k] : (k < 69 ? to_f32(moms[row * 60 + (k - 9)]) : (k == 69 ? meta[row * 4] : 0.f));
  }
#pragma unroll
  for (int j = 0; j < kLoads; ++j)
    if (sub + kLanes * j < kIn) S.in[sub + kLanes * j] = v[j];
  __syncwarp();
  auto mr = [&](int i) { return F(S.in[i]); };
  const F inv_n = F(1.f) / lk::fmax(mr(69), F(1.f));
  F cr[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) cr[i] = mr(i) * inv_n;

  // ---- plane_var, split by output while the eigen warp works: t ----
  // t[b,c,d,a] = s2[b,c,d,a] - s1[b,c,d] cr[a] - s1[b,c,a] cr[d] + s0[b,c] cr[d] cr[a]
#pragma unroll
  for (int j = 0; j < 7; ++j) {
    const int k = min(sub + kLanes * j, 53);
    const int bc = k / 9, di = (k / 3) % 3, ai = k % 3;
    // cr at a run-time index, recomputed (the same product) rather than
    // selected: a select among F values compiles to divergent branches.
    const F cra = mr(ai) * inv_n, crd = mr(di) * inv_n;
    const F t = mr(33 + bc * 6 + sym6(di, ai)) - mr(15 + bc * 3 + di) * cra - mr(15 + bc * 3 + ai) * crd +
                mr(9 + bc) * crd * cra;
    if (sub + kLanes * j < 54) S.t[k] = t.v;
  }
  eigen_done();
  auto bsv = [&](int k, int i, int j) { return F(S.bs[k][3 * i + j]); };

  // w (18 values) and u (6), three a lane.
  // w_j[b,a] = sum_{c,d} b_j[c,d] t[b,c,d,a]
  auto w_at = [&](int k) {
    const int j = k / 9, bi = (k / 3) % 3, ai = k % 3;
    F acc = bsv(j, 0, 0) * F(S.t[sym6(bi, 0) * 9 + ai]);
#pragma unroll
    for (int ci = 0; ci < 3; ++ci)
#pragma unroll
      for (int di = 0; di < 3; ++di)
        if (ci || di) acc = acc + bsv(j, ci, di) * F(S.t[sym6(bi, ci) * 9 + di * 3 + ai]);
    S.w[j][3 * bi + ai] = acc.v;
  };
  w_at(sub);
  w_at(sub + kLanes);
  if (sub < 2) {
    w_at(sub + 2 * kLanes);
  } else {
    // p1m[b,c,a] = s1[b,c,a] - s0[b,c] cr[a];  u_i[c] = sum_{a,b} b_i[a,b] p1m[b,c,a]
    const int i = (sub - 2) / 3, ci = (sub - 2) % 3;
    auto s1v = [&](int b_, int c_, int d_) { return mr(15 + sym6(b_, c_) * 3 + d_); };
    F acc = bsv(i, 0, 0) * (s1v(0, ci, 0) - mr(9 + sym6(0, ci)) * cr[0]);
#pragma unroll
    for (int ai = 0; ai < 3; ++ai)
#pragma unroll
      for (int bi = 0; bi < 3; ++bi)
        if (ai || bi) acc = acc + bsv(i, ai, bi) * (s1v(bi, ci, ai) - mr(9 + sym6(bi, ci)) * cr[ai]);
    S.us[sub - 2] = acc.v;
  }
  __syncwarp();

  // c_ij = sum_{a,b} b_i[a,b] w_j[b,a]
  if (sub < 4) {
    const int i = sub / 2, j = sub % 2;
    F acc = bsv(i, 0, 0) * F(S.w[j][0]);
#pragma unroll
    for (int ai = 0; ai < 3; ++ai)
#pragma unroll
      for (int bi = 0; bi < 3; ++bi)
        if (ai || bi) acc = acc + bsv(i, ai, bi) * F(S.w[j][3 * bi + ai]);
    S.c[sub] = acc.v;
  }
  __syncwarp();

  // The upper triangle of the 6x6 [[t_nn, t_nq], [t_nq^T, s0 / n^2]], zeroed
  // off planes: t_nn (6 values) and t_nq (9) a lane each.
  const F a0(S.alpha[0]), a1(S.alpha[1]), is_plane_f(S.is_plane);
  float* o = out + (long long)slot * 35;
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    const int h = sub + kLanes * jj;
    if (h >= 15) break;
    int r_, c_;
    F x;
    if (h < 6) {
      r_ = h < 3 ? 0 : (h < 5 ? 1 : 2);
      const int s_ = h < 3 ? h : (h < 5 ? h - 2 : 2);
      const F e0r(S.e12[0][r_]), e1r(S.e12[1][r_]), e0s(S.e12[0][s_]), e1s(S.e12[1][s_]);
      x = a0 * a0 * F(S.c[0]) * e0r * e0s;
      x = x + a0 * a1 * F(S.c[1]) * e0r * e1s;
      x = x + a1 * a0 * F(S.c[2]) * e1r * e0s;
      x = x + a1 * a1 * F(S.c[3]) * e1r * e1s;
      c_ = s_;
    } else {
      r_ = (h - 6) / 3;
      const int s_ = (h - 6) % 3;
      x = a0 * inv_n * F(S.e12[0][r_]) * F(S.us[s_]) + a1 * inv_n * F(S.e12[1][r_]) * F(S.us[3 + s_]);
      c_ = 3 + s_;
    }
    if (live) o[10 + tri6(r_, c_)] = (x * is_plane_f).v;
  }
}

}  // namespace

// moms_dtype: 0 f32, 1 f16, 2 bf16 (voxel_map._STORAGE).
LK_API int fit_slots_launch(const float* par, const float* meta, const float* mom, const void* moms,
                            const long long* fs, float* out, int B, int M, int moms_dtype, void* stream) {
  if (B <= 0) return 0;
  const int grid = lk_blocks(B, kSlots);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (moms_dtype) {
    case 0:
      fit_slots_kernel<float><<<grid, kThreads, 0, st>>>(par, meta, mom, static_cast<const float*>(moms), fs, out, B, M);
      break;
    case 1:
      fit_slots_kernel<__half><<<grid, kThreads, 0, st>>>(par, meta, mom, static_cast<const __half*>(moms), fs, out, B, M);
      break;
    case 2:
      fit_slots_kernel<__nv_bfloat16>
          <<<grid, kThreads, 0, st>>>(par, meta, mom, static_cast<const __nv_bfloat16*>(moms), fs, out, B, M);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
