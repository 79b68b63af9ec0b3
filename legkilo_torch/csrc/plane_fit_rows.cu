// Voxel-map plane refit over the refit slots of one insert, for sm_90a.
//
// Replaces the JAX package's Pallas kernel _fit_kernel
// (ops/pallas/plane_fit_rows.py:122, driven by fit_rows_call :295) and
// computes what it computes, one thread per refit slot, in its
// [component, slot] layout:
//
//   par  [8]      planer_threshold at [0]
//   mom  [69, B]  packed moments: m1(3) m2(6) | s0(6) s1(18) s2(36)
//   meta [4,  B]  n, new_n, initialized, is_plane
//   out  [35, B]  centre_rel(3) normal(3) evals(3) radius(1) plane_var(21)
//                 | n, 0, 1, is_plane
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
// and the order of operations of ops/plane_fit_rows.fit_rows_plain.  The
// zero-filled padding slots (n = 1, zero moments) run the diagonal and
// eigenvector-fallback branches and stay finite.
//
// Bound on the H100: at the main path's B = 1024 slots it reads 73 and
// writes 35 floats a slot (442 KB) and does ~1.6k flops a slot; one launch
// of 1024 threads is far below both roofs, so launch latency dominates.
// The 54 distinct values of t[b,c,d,a] (symmetric in b,c) are computed
// once and kept in registers; ptxas reports the register count and spills.

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
  return a == 0 ? b : (a == 1 ? 2 + b : 5);
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

__global__ void fit_kernel(const float* __restrict__ par, const float* __restrict__ mom,
                           const float* __restrict__ meta, float* __restrict__ out, int B) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= B) return;
  auto mr = [&](int i) { return F(mom[i * B + col]); };
  auto s1v = [&](int b, int c, int d) { return mr(15 + sym6(b, c) * 3 + d); };
  auto s2v = [&](int b, int c, int d, int a) { return mr(33 + sym6(b, c) * 6 + sym6(d, a)); };

  const F threshold(par[0]);
  const F n_raw(meta[col]);
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
  const F e_max_t = q + F(2.f) * p * lk::fcos(phi);
  const F e_min_t = q + F(2.f) * p * lk::fcos(phi + F(kTwoPiThird));
  const F e_mid_t = F(3.f) * q - e_max_t - e_min_t;

  const F d0 = cov[0][0], d1 = cov[1][1], d2 = cov[2][2];
  const F dmin = lk::fmin(lk::fmin(d0, d1), d2);
  const F dmax = lk::fmax(lk::fmax(d0, d1), d2);
  const F dmid = d0 + d1 + d2 - dmin - dmax;
  const F lam_min = sel(diagonal, dmin, e_min_t);
  const F lam_mid = sel(diagonal, dmid, e_mid_t);
  const F lam_max = sel(diagonal, dmax, e_max_t);

  // ---- eigenvectors ----
  F v_min[3], v_max[3], v_mid[3], fb[3];
  eigvec(cov, lam_min, v_min);
  eigvec(cov, lam_max, v_max);
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

  const bool is_plane = lam_min < threshold;
  const F is_plane_f(is_plane ? 1.f : 0.f);

  // ---- plane_var ----
  const F e12[2][3] = {{v_mid[0], v_mid[1], v_mid[2]}, {v_max[0], v_max[1], v_max[2]}};
  const F lam12[2] = {lam_mid, lam_max};
  F alphas[2], bs[2][3][3];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    F denom = n * (lam_min - lam12[k]);
    denom = sel(lk::fabs(denom) < F(kAlphaEps), F(-kAlphaEps), denom);
    alphas[k] = F(1.f) / denom;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) bs[k][i][j] = e12[k][i] * v_min[j] + v_min[i] * e12[k][j];
  }

  // t[b,c,d,a] = s2[b,c,d,a] - s1[b,c,d] cr[a] - s1[b,c,a] cr[d] + s0[b,c] cr[d] cr[a],
  // symmetric in (b, c): 6 x 9 distinct values.
  F t[6][3][3];
#pragma unroll
  for (int bi = 0; bi < 3; ++bi)
#pragma unroll
    for (int ci = bi; ci < 3; ++ci)
#pragma unroll
      for (int di = 0; di < 3; ++di)
#pragma unroll
        for (int ai = 0; ai < 3; ++ai)
          t[sym6(bi, ci)][di][ai] = s2v(bi, ci, di, ai) - s1v(bi, ci, di) * cr[ai] -
                                    s1v(bi, ci, ai) * cr[di] + s0[bi][ci] * cr[di] * cr[ai];

  // w_j[b,a] = sum_{c,d} b_j[c,d] t[b,c,d,a];  c_ij = sum_{a,b} b_i[a,b] w_j[b,a]
  F c_mat[2][2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    F w[3][3];
#pragma unroll
    for (int bi = 0; bi < 3; ++bi)
#pragma unroll
      for (int ai = 0; ai < 3; ++ai) {
        F acc = bs[j][0][0] * t[sym6(bi, 0)][0][ai];
#pragma unroll
        for (int ci = 0; ci < 3; ++ci)
#pragma unroll
          for (int di = 0; di < 3; ++di)
            if (ci || di) acc = acc + bs[j][ci][di] * t[sym6(bi, ci)][di][ai];
        w[bi][ai] = acc;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      F acc = bs[i][0][0] * w[0][0];
#pragma unroll
      for (int ai = 0; ai < 3; ++ai)
#pragma unroll
        for (int bi = 0; bi < 3; ++bi)
          if (ai || bi) acc = acc + bs[i][ai][bi] * w[bi][ai];
      c_mat[i][j] = acc;
    }
  }

  // p1m[b,c,a] = s1[b,c,a] - s0[b,c] cr[a];  u_i[c] = sum_{a,b} b_i[a,b] p1m[b,c,a]
  F us[2][3];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int ci = 0; ci < 3; ++ci) {
      F acc = bs[i][0][0] * (s1v(0, ci, 0) - s0[0][ci] * cr[0]);
#pragma unroll
      for (int ai = 0; ai < 3; ++ai)
#pragma unroll
        for (int bi = 0; bi < 3; ++bi)
          if (ai || bi) acc = acc + bs[i][ai][bi] * (s1v(bi, ci, ai) - s0[bi][ci] * cr[ai]);
      us[i][ci] = acc;
    }

  F t_nn[3][3], t_nq[3][3];
#pragma unroll
  for (int r_ = 0; r_ < 3; ++r_)
#pragma unroll
    for (int s_ = 0; s_ < 3; ++s_) {
      F acc_nn = alphas[0] * alphas[0] * c_mat[0][0] * e12[0][r_] * e12[0][s_];
      acc_nn = acc_nn + alphas[0] * alphas[1] * c_mat[0][1] * e12[0][r_] * e12[1][s_];
      acc_nn = acc_nn + alphas[1] * alphas[0] * c_mat[1][0] * e12[1][r_] * e12[0][s_];
      acc_nn = acc_nn + alphas[1] * alphas[1] * c_mat[1][1] * e12[1][r_] * e12[1][s_];
      t_nn[r_][s_] = acc_nn;
      t_nq[r_][s_] = alphas[0] * inv_n * e12[0][r_] * us[0][s_] +
                     alphas[1] * inv_n * e12[1][r_] * us[1][s_];
    }
  const F inv_n2 = inv_n * inv_n;

  int o = 0;
  auto put = [&](F x) { out[(o++) * B + col] = x.v; };
#pragma unroll
  for (int i = 0; i < 3; ++i) put(cr[i]);
#pragma unroll
  for (int i = 0; i < 3; ++i) put(v_min[i]);
  put(lam_min);
  put(lam_mid);
  put(lam_max);
  put(lk::fsqrt(lk::fmax(lam_max, F(0.f))));
  // Upper triangle of the 6x6 [[t_nn, t_nq], [t_nq^T, s0 / n^2]], zeroed off planes.
#pragma unroll
  for (int r_ = 0; r_ < 6; ++r_)
#pragma unroll
    for (int c_ = r_; c_ < 6; ++c_) {
      F x;
      if (c_ < 3) x = t_nn[r_][c_];
      else if (r_ < 3) x = t_nq[r_][c_ - 3];
      else x = s0[r_ - 3][c_ - 3] * inv_n2;
      put(x * is_plane_f);
    }
  put(n_raw);
  put(F(0.f));
  put(F(1.f));
  put(is_plane_f);
}

}  // namespace

LK_API int fit_rows_launch(const float* par, const float* mom, const float* meta, float* out, int B,
                           void* stream) {
  const int threads = 64;
  fit_kernel<<<lk_blocks(B, threads), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      par, mom, meta, out, B);
  return static_cast<int>(cudaGetLastError());
}
