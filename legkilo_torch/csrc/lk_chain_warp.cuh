// Device functions of the one-warp ESKF chain, for both chain kernels and
// both branches (chain_stats.cu's chain_warp_kernel, chain_points.cu's
// chain_points_warp_kernel): ONE warp of 32 lanes walks the buckets with the
// filter state in registers, and nothing waits on a block barrier.
//
// Layout.  Lane c holds column c of the 30x30 covariance P in p[0..29]
// (lanes 30 and 31 hold zeros).  Every lane holds its own copy of the
// nominal state (rot, lin) and of the two clocks, and computes exp3, the
// retraction and the small 6x6 and 3x3 inverses itself, from values that
// every lane read from the same shared-memory words or that a butterfly of
// shuffles left bit-identical on every lane; the copies stay equal without a
// broadcast of any result.  P is symmetric, so row c of P is lane c's
// column: P H^T = (H P)^T and P[:, 0:6] need no transpose.  What a lane
// needs from other lanes' columns goes through a small warp-private shared
// buffer and one __syncwarp().
//
// Order of the arithmetic.  The products keep the summation order of
// eskf_fused where the layout allows it.  Where the layout departs from it
// (F P F^T as Q1 + Q1 D^T with its lower block from Q1's rows, P H^T read as
// (H P)^T, P[:, 0:6] read down the columns, S Phi read from S^T, exp3's
// series, the kinematic gain formed from the Schur blocks of S without
// S^-1, the points' normal equations summed a lane a stride of 32 rows and
// then across the lanes by a butterfly), the same factorisation is written
// in plain torch in tests/test_torch_chain_warp.py and
// tests/test_torch_points_warp.py and held against the plain versions.
//
// Staging.  The caller copies the scan's event and bucket rows to shared
// memory before the walk, and each bucket's inputs to the point update (the
// fused chain's 6,400 B of statistics by cp.async, or the per-point chain's
// 9 P floats of point rows by bulk copies) into a two-slot ring one bucket
// ahead, so no device-memory load sits on the recursion's critical path.
#pragma once

#include <type_traits>

#include "lk_common.cuh"

namespace lk_warp {

constexpr int NW = 32;     // lanes: one warp
constexpr int LDQ = 33;    // padded row of the column exchange buffers
constexpr int LDK = 8;     // 16-byte row of the small buffers: 6 entries, dx, pad
constexpr int S40 = 1600;  // floats of one bucket's 40x40 statistics
constexpr int NACC = 28;   // the point phase's sums: A's upper triangle (21), b (6), sum m

// Warp-private shared memory (static; the staged rows and the ring are the
// caller's).  The members read as float4 come first, so they are 16-byte
// aligned.
struct __align__(16) Smem {
  float kb[NW * LDK];   // gain row i at [i * LDK + 0:6], dx[i] at [i * LDK + 6]
  float sb[6 * LDK];    // a replicated 6x6 matrix: S = H P H^T + R, or I + A P66
  float xq[NW * LDQ];   // predict: xq[k * LDQ + r] = Q1[r][k], rows 0:9 of column k of Q1
  float sp[30 * 7];     // S Phi, rows 0:30
  float nq[21];         // (Phi^T S Phi)[0:3, 0:7]
  float prm[40];        // q_diag(30) imu_r(6) g_over_acc_norm kin_noise pad(2)
};

constexpr int LDH = 20;  // row of hpb and kg: 18 entries (+ dx) in five 16-byte pieces
constexpr int L9 = 12;   // row of a 9x9 block: 9 entries in three 16-byte pieces

// The kinematic branch's buffers, after the common ones.  Every array read
// as float4 holds a multiple of four floats, so each stays 16-byte aligned.
struct __align__(16) KinSmem : Smem {
  float hf[4 * 24];      // foot f at hf[24 f]: h_rot (9), h_w (9), z (3), c, r, pad
  float hpb[NW * LDH];   // lane c's column of H P: hpb[c * LDH + j] = (H P)[j][c]
  float sk[18 * LDH];    // S = H P H^T + R, row-major
  float ai[9 * L9];      // A^-1 (A = S[0:9, 0:9])
  float aib[9 * L9];     // A^-1 B (B = S[0:9, 9:18])
  float cai[9 * L9];     // C A^-1 (C = S[9:18, 0:9])
  float sc[9 * L9];      // D - C A^-1 B (D = S[9:18, 9:18])
  float si[9 * L9];      // its inverse
  float kg[NW * LDH];    // gain row c at kg[c * LDH + 0:18], dx[c] at kg[c * LDH + 18]
  float s6[6 * LDK];     // inv9: the Schur complement of its leading 3x3 block
  float x3[3 * 6];       // inv9: Ai3 M[0:3, 3:9]
  float y3[6 * 3];       // inv9: M[3:9, 0:3] Ai3
};

template <bool KIN>
using SmemOf = typename std::conditional<KIN, KinSmem, Smem>::type;

// ---- copies to shared memory (cp.async; complete at cp_wait) ----

static __device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
static __device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
static __device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this lane's committed groups are still in flight.
template <int N>
static __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Bulk copies by the Tensor Memory Accelerator: one lane issues a copy of
// any multiple of 16 bytes (16-byte aligned both sides); the bytes' arrival
// completes the phase of an mbarrier in shared memory that every lane waits on.
static __device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
static __device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}
// The barriers' initialisation, then visible to the bulk copies.
static __device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Shared memory read by the lanes before, overwritten by bulk copies after.
static __device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
static __device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
}
static __device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes,
                                                 unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}
// Wait until the barrier's phase of the given parity has completed.
static __device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity) : "memory");
}

// ---- end of the copies ----

// n floats, any alignment; lane l copies l, l + 32, ...
static __device__ __forceinline__ void stage(float* dst, const float* src, int n, int lane) {
  for (int e = lane; e < n; e += NW) cp_async4(dst + e, src + e);
}

// One bucket's statistics, 16 bytes a copy (src 16-byte aligned).
static __device__ __forceinline__ void stage_s40(float* dst, const float* src, int lane) {
#pragma unroll
  for (int m = 0; m < (S40 / 4 + NW - 1) / NW; ++m) {
    const int e = lane + NW * m;
    if (e < S40 / 4) cp_async16(dst + 4 * e, src + 4 * e);
  }
}

// One bucket's P point rows into a ring slot of 9 P floats: pi (3 P) | n
// (3 P) | nd | r | m (P each).  bulk (P % 4 == 0 and every source 16-byte
// aligned, the caller's test): lane 0 issues five bulk copies that complete
// on bar; else every lane 4-byte cp.async copies, in the caller's group.
static __device__ __forceinline__ void stage_points(float* dst, const float* pi, const float* n,
                                                    const float* nd, const float* r,
                                                    const float* m, int P, bool bulk,
                                                    unsigned long long* bar, int lane) {
  if (bulk) {
    if (lane == 0) {
      const unsigned b1 = 4u * static_cast<unsigned>(P);
      fence_proxy_async();
      mbar_expect_tx(bar, 9 * b1);
      bulk_copy(dst, pi, 3 * b1, bar);
      bulk_copy(dst + 3 * P, n, 3 * b1, bar);
      bulk_copy(dst + 6 * P, nd, b1, bar);
      bulk_copy(dst + 7 * P, r, b1, bar);
      bulk_copy(dst + 8 * P, m, b1, bar);
    }
  } else {
    stage(dst, pi, 3 * P, lane);
    stage(dst + 3 * P, n, 3 * P, lane);
    stage(dst + 6 * P, nd, P, lane);
    stage(dst + 7 * P, r, P, lane);
    stage(dst + 8 * P, m, P, lane);
  }
}

// Four floats from a 16-byte aligned shared-memory address.
static __device__ __forceinline__ void ld4(const float* s, float& a, float& b, float& c, float& d) {
  const float4 v = *reinterpret_cast<const float4*>(s);
  a = v.x;
  b = v.y;
  c = v.z;
  d = v.w;
}

static __device__ __forceinline__ void st4(float* s, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(s) = make_float4(a, b, c, d);
}

// A 6x6 matrix from its LDK rows, on every lane.
static __device__ __forceinline__ void load6x6(const float* s, float (&m)[36]) {
  float pad0, pad1;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    ld4(s + i * LDK, m[6 * i], m[6 * i + 1], m[6 * i + 2], m[6 * i + 3]);
    ld4(s + i * LDK + 4, m[6 * i + 4], m[6 * i + 5], pad0, pad1);
  }
}

// ---- 3x3 helpers on a lane's registers (row-major) ----

static __device__ __forceinline__ void mm3(const float* a, const float* b, float* o) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      o[3 * i + j] = a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] + a[3 * i + 2] * b[6 + j];
}

// The coefficients of the Rodrigues exponential, sin(t)/t and
// (1 - cos t)/t^2, from t^2: their Taylor series to t^8, used below
// theta = 0.5 (a filter step's rotation is far smaller; truncation below
// 3e-11; it also covers the plain version's small-angle branch).
static __device__ __forceinline__ void exp3_series(float t2, float& a, float& b) {
  a = 1.0f + t2 * (-1.0f / 6.0f + t2 * (1.0f / 120.0f + t2 * (-1.0f / 5040.0f + t2 * (1.0f / 362880.0f))));
  b = 0.5f + t2 * (-1.0f / 24.0f + t2 * (1.0f / 720.0f + t2 * (-1.0f / 40320.0f + t2 * (1.0f / 3628800.0f))));
}

// The series below theta = 0.5, sinf and cosf above it.
static __device__ __forceinline__ void exp3_coef(float t2, float& a, float& b) {
  if (t2 < 0.25f) {
    exp3_series(t2, a, b);
  } else {
    const float t = sqrtf(t2);
    a = sinf(t) / t;
    b = (1.0f - cosf(t)) / t2;
  }
}

// I + a [w]x + b [w]x^2, written out (the products with the zeros of [w]x
// dropped).
static __device__ __forceinline__ void exp3_mat(const float* w, float a, float b, float* o) {
  const float x01 = w[0] * w[1], x02 = w[0] * w[2], x12 = w[1] * w[2];
  const float x00 = w[0] * w[0], x11 = w[1] * w[1], x22 = w[2] * w[2];
  o[0] = 1.0f + b * (-x22 - x11);
  o[1] = -a * w[2] + b * x01;
  o[2] = a * w[1] + b * x02;
  o[3] = a * w[2] + b * x01;
  o[4] = 1.0f + b * (-x22 - x00);
  o[5] = -a * w[0] + b * x12;
  o[6] = -a * w[1] + b * x02;
  o[7] = a * w[0] + b * x12;
  o[8] = 1.0f + b * (-x11 - x00);
}

static __device__ __forceinline__ float norm2(const float* w) {
  return w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
}

// Rodrigues exponential Exp(w).
static __device__ __forceinline__ void exp3(const float* w, float* o) {
  float a, b;
  exp3_coef(norm2(w), a, b);
  exp3_mat(w, a, b, o);
}

// Exp(w) and Exp(v) under one branch, so their chains interleave.
static __device__ __forceinline__ void exp3x2(const float* w, const float* v, float* ow, float* ov) {
  const float tw = norm2(w), tv = norm2(v);
  float aw, bw, av, bv;
  if (fmaxf(tw, tv) < 0.25f) {
    exp3_series(tw, aw, bw);
    exp3_series(tv, av, bv);
  } else {
    exp3_coef(tw, aw, bw);
    exp3_coef(tv, av, bv);
  }
  exp3_mat(w, aw, bw, ow);
  exp3_mat(v, av, bv, ov);
}

// rot <- rot Exp(dx[0:3]); lin[0:n] += dx[3:3+n].
template <int N>
static __device__ __forceinline__ void retract(float (&rot)[9], float (&lin)[27], const float* dx) {
  float E[9], R[9];
  exp3(dx, E);
  mm3(rot, E, R);
#pragma unroll
  for (int k = 0; k < 9; ++k) rot[k] = R[k];
#pragma unroll
  for (int k = 0; k < N; ++k) lin[k] += dx[3 + k];
}

// Adjugate inverse of the 3x3 block at m (row stride ld) into o; the
// determinant's reciprocal by __fdividef (within 2 ulp, no slow-path branch).
static __device__ __forceinline__ void inv3(const float* m, int ld, float* o) {
  const float a = m[0], b = m[1], c = m[2];
  const float d = m[ld], e = m[ld + 1], f = m[ld + 2];
  const float g = m[2 * ld], h = m[2 * ld + 1], i = m[2 * ld + 2];
  const float co[9] = {e * i - f * h, c * h - b * i, b * f - c * e,
                       f * g - d * i, a * i - c * g, c * d - a * f,
                       d * h - e * g, b * g - a * h, a * e - b * d};
  const float inv_det = __fdividef(1.0f, a * co[0] + b * co[3] + c * co[6]);
#pragma unroll
  for (int k = 0; k < 9; ++k) o[k] = co[k] * inv_det;
}

// 6x6 inverse through the Schur complement of the leading 3x3 block, in the
// order of eskf_fused._inv_schur.
static __device__ __forceinline__ void inv6(const float (&m)[36], float (&o)[36]) {
  float Ai[9], AiB[9], CAi[9], Sc[9], Si[9], AiBSi[9];
  inv3(m, 6, Ai);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float s = Ai[3 * i] * m[3 + j];  // Ai B
#pragma unroll
      for (int t = 1; t < 3; ++t) s += Ai[3 * i + t] * m[6 * t + 3 + j];
      AiB[3 * i + j] = s;
      float u = m[6 * (3 + i)] * Ai[j];  // C Ai
#pragma unroll
      for (int t = 1; t < 3; ++t) u += m[6 * (3 + i) + t] * Ai[3 * t + j];
      CAi[3 * i + j] = u;
    }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float s = m[6 * (3 + i)] * AiB[j];
#pragma unroll
      for (int t = 1; t < 3; ++t) s += m[6 * (3 + i) + t] * AiB[3 * t + j];
      Sc[3 * i + j] = m[6 * (3 + i) + 3 + j] - s;
    }
  inv3(Sc, 3, Si);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float s = AiB[3 * i] * Si[j];
#pragma unroll
      for (int t = 1; t < 3; ++t) s += AiB[3 * i + t] * Si[3 * t + j];
      AiBSi[3 * i + j] = s;
    }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float s = AiBSi[3 * i] * CAi[j];
#pragma unroll
      for (int t = 1; t < 3; ++t) s += AiBSi[3 * i + t] * CAi[3 * t + j];
      o[6 * i + j] = Ai[3 * i + j] + s;
      o[6 * i + 3 + j] = -AiBSi[3 * i + j];
      float u = Si[3 * i] * CAi[j];
#pragma unroll
      for (int t = 1; t < 3; ++t) u += Si[3 * i + t] * CAi[3 * t + j];
      o[6 * (3 + i) + j] = -u;
      o[6 * (3 + i) + 3 + j] = Si[3 * i + j];
    }
}

// ---- the filter steps; every lane calls each one ----

// Dual-clock predict (eskf.cc:64-89).  F = I + D with D nonzero in rows 0:9,
// so F P F^T = Q1 F^T = Q1 + Q1 D^T with Q1 = F P.  Each lane applies D to
// its own column (Q1 = P + D P, rows 0:9) and publishes rows 0:9 of it; that
// finishes columns 9:30.  Lane c < 9 then forms column c of Q1 D^T, which
// is nonzero in columns 0:9 only: rows 0:9 as Q1[r][c] + sum_k Q1[r][k]
// D[c][k] from the published rows, and rows 9:30 as Q1[c][r] (the result
// is symmetric, and row c of Q1 on those columns is what lanes 9-29
// published).  Then the process noise on the diagonal.  The mean over
// dt_mean, x <- x boxplus f(x) dt (eskf.cc:64-70), reads the old state only:
// it is formed first, so its latency hides under the rest.
static __device__ __forceinline__ void predict(float (&p)[30], float (&rot)[9], float (&lin)[27],
                                               float qc, int lane, float dtm, float dtc,
                                               Smem& sm) {
  float rot_n[9], dlin[6], a[9], vb[9], dr[9];
  {
    float Em[9], E[9];
    const float wm[3] = {dtm * lin[18], dtm * lin[19], dtm * lin[20]};
    const float wc[3] = {-dtc * lin[18], -dtc * lin[19], -dtc * lin[20]};
    exp3x2(wm, wc, Em, E);
    mm3(rot, Em, rot_n);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float* r = rot + 3 * i;
      const float acc_w = r[0] * lin[15] + r[1] * lin[16] + r[2] * lin[17] + lin[12 + i];
      dlin[i] = dtm * lin[3 + i];
      dlin[3 + i] = dtm * acc_w;
      // rot [imu_a]x, row i, written out
      const float rs[3] = {r[1] * lin[17] - r[2] * lin[16], r[2] * lin[15] - r[0] * lin[17],
                           r[0] * lin[16] - r[1] * lin[15]};
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        a[3 * i + j] = E[3 * i + j] - (i == j ? 1.0f : 0.0f);
        vb[3 * i + j] = -dtc * rs[j];
        dr[3 * i + j] = dtc * r[j];
      }
    }
  }
  float d[9];  // (D P)[0:9, lane]
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    d[r] = a[3 * r] * p[0] + a[3 * r + 1] * p[1] + a[3 * r + 2] * p[2] + dtc * p[21 + r];
    d[3 + r] = dtc * p[6 + r];
    d[6 + r] = vb[3 * r] * p[0] + vb[3 * r + 1] * p[1] + vb[3 * r + 2] * p[2] + dtc * p[15 + r] +
               (dr[3 * r] * p[18] + dr[3 * r + 1] * p[19] + dr[3 * r + 2] * p[20]);
  }
#pragma unroll
  for (int r = 0; r < 9; ++r) {
    p[r] += d[r];
    sm.xq[lane * LDQ + r] = p[r];
  }
  __syncwarp();
  if (lane < 9) {
    // Row `lane` of D: f on columns 0:3, dtc on column k1, e on columns 18:21.
    float f0 = 0.f, f1 = 0.f, f2 = 0.f, e0 = 0.f, e1 = 0.f, e2 = 0.f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (lane == i) {
        f0 = a[3 * i]; f1 = a[3 * i + 1]; f2 = a[3 * i + 2];
      }
      if (lane == 6 + i) {
        f0 = vb[3 * i]; f1 = vb[3 * i + 1]; f2 = vb[3 * i + 2];
        e0 = dr[3 * i]; e1 = dr[3 * i + 1]; e2 = dr[3 * i + 2];
      }
    }
    const int k1 = lane < 3 ? 21 + lane : (lane < 6 ? 3 + lane : 9 + lane);
    const float* x0 = sm.xq;
    const float* xk = sm.xq + k1 * LDQ;
    const float* x18 = sm.xq + 18 * LDQ;
#pragma unroll
    for (int r = 0; r < 9; ++r) {
      p[r] += f0 * x0[r] + f1 * x0[LDQ + r] + f2 * x0[2 * LDQ + r] + dtc * xk[r] +
              (e0 * x18[r] + e1 * x18[LDQ + r] + e2 * x18[2 * LDQ + r]);
    }
#pragma unroll
    for (int r = 9; r < 30; ++r) p[r] = sm.xq[r * LDQ + lane];
  }
#pragma unroll
  for (int r = 0; r < 30; ++r)
    if (r == lane) p[r] += (dtc * dtc) * qc;
#pragma unroll
  for (int k = 0; k < 9; ++k) rot[k] = rot_n[k];
#pragma unroll
  for (int k = 0; k < 6; ++k) lin[k] += dlin[k];
}

// The downdate P -= K M of a lane's column, with row i of the gain K and
// dx[i] at kb[i * LDK] and the lane's column of M in m; then every lane's
// retraction by dx.
static __device__ __forceinline__ void downdate_retract(float (&p)[30], float (&rot)[9],
                                                        float (&lin)[27], const float (&m)[6],
                                                        const float* kb) {
  float dx[30];
#pragma unroll
  for (int i = 0; i < 30; ++i) {
    float k0, k1, k2, k3, k4, k5, pad;
    ld4(kb + i * LDK, k0, k1, k2, k3);
    ld4(kb + i * LDK + 4, k4, k5, dx[i], pad);
    const float v = k0 * m[0] + k1 * m[1] + k2 * m[2] + k3 * m[3] + k4 * m[4] + k5 * m[5];
    p[i] = p[i] - v;
  }
  retract<27>(rot, lin, dx);
}

// Structured 6-row IMU update (eskf.cc:125-135).  H P = P[9:15] + P[18:24]
// is local to each column, and (P H^T)[lane] = (H P)[:, lane] since P is
// symmetric: lane c forms row c of the gain K = P H^T S^-1 itself.  Row i
// of S = H P H^T + R is (H P)^T's rows 9 + i and 18 + i: lanes 9-14 add
// the row of lane + 9 (a shuffle) to their own and publish it.  The gain
// rows go through kb for the downdate P -= K (H P).
static __device__ __forceinline__ void update_imu(float (&p)[30], float (&rot)[9],
                                                  float (&lin)[27], int lane, const float* acc,
                                                  const float* gyr, const float* r6,
                                                  float g_over_an, float gate, Smem& sm) {
  float hp[6], hq[6];
#pragma unroll
  for (int t = 0; t < 6; ++t) {
    hp[t] = p[9 + t] + p[18 + t];
    hq[t] = __shfl_down_sync(0xffffffffu, hp[t], 9);
  }
  if (lane >= 9 && lane < 15) {
    float* row = sm.sb + (lane - 9) * LDK;
    st4(row, hp[0] + hq[0], hp[1] + hq[1], hp[2] + hq[2], hp[3] + hq[3]);
    st4(row + 4, hp[4] + hq[4], hp[5] + hq[5], 0.f, 0.f);
  }
  float z[6];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    z[i] = g_over_an * acc[i] - lin[15 + i] - lin[6 + i];
    z[3 + i] = gyr[i] - lin[18 + i] - lin[9 + i];
  }
  __syncwarp();
  float s[36], si[36];
  load6x6(sm.sb, s);
#pragma unroll
  for (int i = 0; i < 6; ++i) s[7 * i] += r6[i];
  inv6(s, si);
  float k[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float v = hp[0] * si[j];
#pragma unroll
    for (int t = 1; t < 6; ++t) v += hp[t] * si[6 * t + j];
    k[j] = v * gate;
  }
  float dxl = k[0] * z[0];
#pragma unroll
  for (int t = 1; t < 6; ++t) dxl += k[t] * z[t];
  st4(sm.kb + lane * LDK, k[0], k[1], k[2], k[3]);
  st4(sm.kb + lane * LDK + 4, k[4], k[5], dxl, 0.f);
  __syncwarp();
  downdate_retract(p, rot, lin, hp, sm.kb);
}

// The information-form point update from the bucket's 6x6 normal equations
// A = sum w h6 h6^T and b = sum w h6 z, on every lane alike
// (eskf.update_by_points): lanes 0-5 form column j of I + A P66 from their
// own column; every lane inverts it, G = (I + A P66)^-1, and forms row
// `lane` of K = (P[:, 0:6] G) A and dx = (P[:, 0:6] G) b from its column
// (P symmetric); P -= K P[0:6, :], then the retraction.  A = b = 0 is an
// exact no-op.
static __device__ __forceinline__ void info_update(float (&p)[30], float (&rot)[9],
                                                   float (&lin)[27], int lane,
                                                   const float (&A)[36], const float (&b)[6],
                                                   Smem& sm) {
  if (lane < 6) {  // column `lane` of I + A P66; P66[t][lane] = p[t]
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float s = A[6 * i] * p[0];
#pragma unroll
      for (int t = 1; t < 6; ++t) s += A[6 * i + t] * p[t];
      sm.sb[i * LDK + lane] = (i == lane ? 1.0f : 0.0f) + s;
    }
  }
  __syncwarp();
  float m[36], g[36];
  load6x6(sm.sb, m);
  inv6(m, g);
  float u[6], pt[6];  // u = P[lane, 0:6] G
#pragma unroll
  for (int t = 0; t < 6; ++t) {
    pt[t] = p[t];
    float s = p[0] * g[t];
#pragma unroll
    for (int q = 1; q < 6; ++q) s += p[q] * g[6 * q + t];
    u[t] = s;
  }
  float k[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = u[0] * A[j];
#pragma unroll
    for (int t = 1; t < 6; ++t) s += u[t] * A[6 * t + j];
    k[j] = s;
  }
  float dxl = u[0] * b[0];
#pragma unroll
  for (int t = 1; t < 6; ++t) dxl += u[t] * b[t];
  st4(sm.kb + lane * LDK, k[0], k[1], k[2], k[3]);
  st4(sm.kb + lane * LDK + 4, k[4], k[5], dxl, 0.f);
  __syncwarp();
  downdate_retract(p, rot, lin, pt, sm.kb);
}

// Point update from the bucket's statistics S = sum w X X^T at S (a ring
// slot; eskf_fused.point_update_from_stats), in information form: lane
// i < 30 forms row i of S Phi, reading row i of S down its column i (S is
// symmetric; column reads hit 32 banks), then lane < 21 one of the 21
// entries of (Phi^T S Phi)[0:3, :]; rows 3:6 of [A b] = (Phi^T S Phi)[0:6, :]
// are rows 27:30 of S Phi.  Then info_update.  S = 0 is an exact no-op.
static __device__ __forceinline__ void update_stats(float (&p)[30], float (&rot)[9],
                                                    float (&lin)[27], int lane, const float* S,
                                                    Smem& sm) {
  const float* R = rot;
  if (lane < 30) {  // rows 30:40 of S Phi enter only row 6 of Phi^T S Phi
    const int i = lane;
    const float* c = S + i;  // S[i][k] read as S[k][i] = c[40 k]
    float v[7];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float s = R[0] * c[40 * (9 * j)];
#pragma unroll
      for (int q = 1; q < 9; ++q) s = s + R[q] * c[40 * (9 * j + q)];
      v[j] = s;
      v[3 + j] = c[40 * (27 + j)];
    }
    float s = c[40 * 39] - c[40 * 27] * lin[0] - c[40 * 28] * lin[1] - c[40 * 29] * lin[2];
#pragma unroll
    for (int q = 0; q < 9; ++q) s = s - R[q] * c[40 * (30 + q)];
    v[6] = s;
#pragma unroll
    for (int j = 0; j < 7; ++j) sm.sp[7 * i + j] = v[j];
  }
  __syncwarp();
  if (lane < 21) {  // rows 0:3 of Phi^T (S Phi); rows 3:6 are rows 27:30 of S Phi
    const int i = lane / 7, j = lane - 7 * (lane / 7);
    const float* w = sm.sp + 63 * i + j;
    float v = R[0] * w[0];
#pragma unroll
    for (int q = 1; q < 9; ++q) v = v + R[q] * w[7 * q];
    sm.nq[lane] = v;
  }
  __syncwarp();
  float A[36], b[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float* row = i < 3 ? sm.nq + 7 * i : sm.sp + 7 * (24 + i);
#pragma unroll
    for (int j = 0; j < 6; ++j) A[6 * i + j] = row[j];
    b[i] = row[6];
  }
  info_update(p, rot, lin, lane, A, b, sm);
}

// ---- the per-point chain's point phase ----

// The lane's share of a bucket's normal equations from its point rows at s
// (a ring slot, stage_points' layout), at the post-predict state (rot, lin):
// the rows lane, lane + 32, ... in that order, each
//     h6 = [p x R^T n, n],  z = -(n . (R p + t) - nd),  w = m gate (r + 1e-4)^-1,
// into acc = [A's upper triangle row by row (21) | b (6) | sum m gate].
static __device__ __forceinline__ void point_rows(const float* s, int P, float gate,
                                                  const float (&rot)[9], const float (&lin)[27],
                                                  int lane, float (&acc)[NACC]) {
  const float* pi = s;
  const float* n = s + 3 * P;
  const float* nd = s + 6 * P;
  const float* r = s + 7 * P;
  const float* m = s + 8 * P;
  const float* R = rot;
#pragma unroll
  for (int q = 0; q < NACC; ++q) acc[q] = 0.f;
  for (int e = lane; e < P; e += NW) {
    const float px = pi[3 * e], py = pi[3 * e + 1], pz = pi[3 * e + 2];
    const float nx = n[3 * e], ny = n[3 * e + 1], nz = n[3 * e + 2];
    const float mv = m[e] * gate;
    // R^T n, then p x R^T n
    const float ux = nx * R[0] + ny * R[3] + nz * R[6];
    const float uy = nx * R[1] + ny * R[4] + nz * R[7];
    const float uz = nx * R[2] + ny * R[5] + nz * R[8];
    const float h[6] = {py * uz - pz * uy, pz * ux - px * uz, px * uy - py * ux, nx, ny, nz};
    const float wx = R[0] * px + R[1] * py + R[2] * pz + lin[0];
    const float wy = R[3] * px + R[4] * py + R[5] * pz + lin[1];
    const float wz = R[6] * px + R[7] * py + R[8] * pz + lin[2];
    const float z = -((nx * wx + ny * wy + nz * wz) - nd[e]);
    const float w = mv * __frcp_rn(r[e] + 1e-4f);  // no division's slow-path branch
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
}

// The lanes' sums added across the warp by an xor butterfly (offsets 16, 8,
// 4, 2, 1): at each step lanes l and l ^ off add the same two values, and
// IEEE addition is commutative, so every lane ends with the bit-identical sum.
static __device__ __forceinline__ void butterfly(float (&acc)[NACC]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int q = 0; q < NACC; ++q) acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], off);
}

// The summed acc as the symmetric A (6x6) and b.
static __device__ __forceinline__ void normal_eq(const float (&acc)[NACC], float (&A)[36],
                                                 float (&b)[6]) {
  int q = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) {
      A[6 * i + j] = acc[q];
      A[6 * j + i] = acc[q];
      ++q;
    }
    b[i] = acc[21 + i];
  }
}

// ---- the kinematic branch ----

// o = rot [v]x, written out (the products with the zeros of [v]x dropped).
static __device__ __forceinline__ void rot_skew(const float (&rot)[9], float v0, float v1,
                                                float v2, float* o) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float r0 = rot[3 * i], r1 = rot[3 * i + 1], r2 = rot[3 * i + 2];
    o[3 * i] = r1 * v2 + r2 * -v1;
    o[3 * i + 1] = r0 * -v2 + r2 * v0;
    o[3 * i + 2] = r0 * v1 + r1 * -v0;
  }
}

// The 9x9 inverse of m (row stride ld, shared memory) into out (row stride
// L9) through the Schur complement of the leading 3x3 block, in the order of
// eskf_fused.inv9 (_inv_schur(m, 3, inv3, inv6)).  Every lane inverts the
// 3x3 block; lanes 0-5 form column l of X = Ai3 M[0:3, 3:9] and of the
// complement M[3:9, 3:9] - M[3:9, 0:3] X, lanes 8-13 row r of
// Y = M[3:9, 0:3] Ai3; then every lane inverts the complement (inv6) and
// forms the four output blocks, which lane 0 stores.  Ends on a __syncwarp().
static __device__ __forceinline__ void inv9(const float* m, int ld, float* out, int lane,
                                            KinSmem& sm) {
  float a3[9];
  inv3(m, ld, a3);
  if (lane < 6) {
    const int l = lane;
    float x[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      x[i] = a3[3 * i] * m[3 + l] + a3[3 * i + 1] * m[ld + 3 + l] + a3[3 * i + 2] * m[2 * ld + 3 + l];
      sm.x3[6 * i + l] = x[i];
    }
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      const float* row = m + (3 + r) * ld;
      sm.s6[r * LDK + l] = row[3 + l] - (row[0] * x[0] + row[1] * x[1] + row[2] * x[2]);
    }
  } else if (lane >= 8 && lane < 14) {
    const int r = lane - 8;
    const float* row = m + (3 + r) * ld;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      sm.y3[3 * r + j] = row[0] * a3[j] + row[1] * a3[3 + j] + row[2] * a3[6 + j];
  }
  __syncwarp();
  float g[36];
  {
    float c6[36];
    load6x6(sm.s6, c6);
    inv6(c6, g);
  }
  float x[18], y[18];
#pragma unroll
  for (int k = 0; k < 18; ++k) {
    x[k] = sm.x3[k];
    y[k] = sm.y3[k];
  }
  float z[18];  // Z = X Si6
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      float v = x[6 * i] * g[j];
#pragma unroll
      for (int t = 1; t < 6; ++t) v += x[6 * i + t] * g[6 * t + j];
      z[6 * i + j] = v;
    }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {  // Ai3 + Z Y
        float v = z[6 * i] * y[j];
#pragma unroll
        for (int t = 1; t < 6; ++t) v += z[6 * i + t] * y[3 * t + j];
        out[i * L9 + j] = a3[3 * i + j] + v;
      }
#pragma unroll
      for (int j = 0; j < 6; ++j) out[i * L9 + 3 + j] = -z[6 * i + j];
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {  // -Si6 Y
        float v = g[6 * i] * y[j];
#pragma unroll
        for (int t = 1; t < 6; ++t) v += g[6 * i + t] * y[3 * t + j];
        out[(3 + i) * L9 + j] = -v;
      }
#pragma unroll
      for (int j = 0; j < 6; ++j) out[(3 + i) * L9 + 3 + j] = g[6 * i + j];
    }
  }
  __syncwarp();
}

// y[0:9] = x[0:9] M for a 9x9 block M at L9 rows (shared memory, read as float4).
static __device__ __forceinline__ void vm9(const float (&x)[9], const float* m, float (&y)[9]) {
  float pad0, pad1, pad2;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    float r[9];
    ld4(m + i * L9, r[0], r[1], r[2], r[3]);
    ld4(m + i * L9 + 4, r[4], r[5], r[6], r[7]);
    ld4(m + i * L9 + 8, r[8], pad0, pad1, pad2);
#pragma unroll
    for (int j = 0; j < 9; ++j) y[j] = i == 0 ? x[0] * r[j] : y[j] + x[i] * r[j];
  }
}

// The 18-row kinematic + IMU update (KILO.cc:260-314, eskf.cc:137-145;
// eskf_fused.build_kin_obs / update_by_kin_imu).  H is nonzero on the
// columns rot 0:3, vel 6:9, ba 9:12, bw 12:15, imu_a 18:21, imu_w 21:24:
// rows 0:6 are the IMU rows (ba + imu_a, bw + imu_w), foot f's rows 6+3f:9+3f
// are c_f [-R [w x p + v]x, I (vel), -R [p]x (imu_w)].
//   1. lanes 0-3 build foot `lane`'s blocks, z and r into hf;
//   2. lane c forms its column of H P (= row c of P H^T, P symmetric) and
//      publishes it in hpb;
//   3. lane j < 18 forms column j of S = H (H P)^T + R from the published
//      columns into sk;
//   4. S^-1 as its Schur blocks (eskf_fused.inv18 = _inv_schur(S, 9, inv9,
//      inv9)): Ai = inv9(A); lanes 0-8 column l of Ai B and of the
//      complement D - C (Ai B), lanes 16-24 row r of C Ai; Si = inv9(D - C Ai B);
//   5. lane c forms its gain row without S^-1: with [u v] its row of P H^T,
//      w = (v - u Ai B) Si and K[c] = [u Ai - w C Ai, w] (times the gate),
//      and dx[c] = K[c] z, and publishes them in kg;
//   6. each lane downdates its column, P -= K (H P), and retracts by dx.
// Nine __syncwarp() in all.
static __device__ __forceinline__ void update_kin(float (&p)[30], float (&rot)[9],
                                                  float (&lin)[27], int lane, const float* acc,
                                                  const float* gyr, const float* fp,
                                                  const float* fv, const float* ct,
                                                  const float* r6, float kin_noise,
                                                  float g_over_an, float gate, KinSmem& sm) {
  if (lane < 4) {  // 1. foot `lane`
    const int f = lane;
    const float p0 = fp[3 * f], p1 = fp[3 * f + 1], p2 = fp[3 * f + 2];
    const float c = ct[f];
    // w x p + v, w = imu_w (lin 18:21)
    const float u0 = -lin[20] * p1 + lin[19] * p2 + fv[3 * f];
    const float u1 = lin[20] * p0 + -lin[18] * p2 + fv[3 * f + 1];
    const float u2 = -lin[19] * p0 + lin[18] * p1 + fv[3 * f + 2];
    float hr[9], hw[9];
    rot_skew(rot, u0, u1, u2, hr);
    rot_skew(rot, p0, p1, p2, hw);
    float zf[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      zf[i] = (-lin[3 + i] - (rot[3 * i] * u0 + rot[3 * i + 1] * u1 + rot[3 * i + 2] * u2)) * c;
    float* o = sm.hf + 24 * f;
    st4(o, -hr[0] * c, -hr[1] * c, -hr[2] * c, -hr[3] * c);
    st4(o + 4, -hr[4] * c, -hr[5] * c, -hr[6] * c, -hr[7] * c);
    st4(o + 8, -hr[8] * c, -hw[0] * c, -hw[1] * c, -hw[2] * c);
    st4(o + 12, -hw[3] * c, -hw[4] * c, -hw[5] * c, -hw[6] * c);
    st4(o + 16, -hw[7] * c, -hw[8] * c, zf[0], zf[1]);
    st4(o + 20, zf[2], c, c > 0.5f ? kin_noise : 1.0f, 0.f);
  }
  __syncwarp();
  {  // 2. (H P)[:, lane]
    float hp[18];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      hp[i] = p[9 + i] + p[18 + i];
      hp[3 + i] = p[12 + i] + p[21 + i];
    }
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const float* h = sm.hf + 24 * f;
      float a[24];
#pragma unroll
      for (int q = 0; q < 6; ++q) ld4(h + 4 * q, a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
#pragma unroll
      for (int i = 0; i < 3; ++i)
        hp[6 + 3 * f + i] = a[3 * i] * p[0] + a[3 * i + 1] * p[1] + a[3 * i + 2] * p[2] +
                            a[21] * p[6 + i] + a[9 + 3 * i] * p[21] + a[10 + 3 * i] * p[22] +
                            a[11 + 3 * i] * p[23];
    }
    float* o = sm.hpb + lane * LDH;
#pragma unroll
    for (int q = 0; q < 4; ++q) st4(o + 4 * q, hp[4 * q], hp[4 * q + 1], hp[4 * q + 2], hp[4 * q + 3]);
    st4(o + 16, hp[16], hp[17], 0.f, 0.f);
  }
  __syncwarp();
  if (lane < 18) {  // 3. column `lane` of S: row `lane` of H P read down the columns
    const int j = lane;
    float x[24];
#pragma unroll
    for (int t = 0; t < 24; ++t) x[t] = (t >= 3 && t < 6) || (t >= 15 && t < 18) ? 0.f : sm.hpb[t * LDH + j];
    float* o = sm.sk + j;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      o[i * LDH] = x[9 + i] + x[18 + i] + (i == j ? r6[i] : 0.f);
      o[(3 + i) * LDH] = x[12 + i] + x[21 + i] + (3 + i == j ? r6[3 + i] : 0.f);
    }
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const float* h = sm.hf + 24 * f;
      float a[24];
#pragma unroll
      for (int q = 0; q < 6; ++q) ld4(h + 4 * q, a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int row = 6 + 3 * f + i;
        o[row * LDH] = a[3 * i] * x[0] + a[3 * i + 1] * x[1] + a[3 * i + 2] * x[2] +
                       a[21] * x[6 + i] + a[9 + 3 * i] * x[21] + a[10 + 3 * i] * x[22] +
                       a[11 + 3 * i] * x[23] + (row == j ? a[22] : 0.f);
      }
    }
  }
  __syncwarp();
  inv9(sm.sk, LDH, sm.ai, lane, sm);  // 4. Ai
  if (lane < 9) {  // column l of Ai B, then of D - C (Ai B)
    const int l = lane;
    float b[9], v[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) b[t] = sm.sk[t * LDH + 9 + l];
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      const float* a = sm.ai + i * L9;
      float s = a[0] * b[0];
#pragma unroll
      for (int t = 1; t < 9; ++t) s += a[t] * b[t];
      v[i] = s;
      sm.aib[i * L9 + l] = s;
    }
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      const float* c = sm.sk + (9 + i) * LDH;
      float s = c[0] * v[0];
#pragma unroll
      for (int t = 1; t < 9; ++t) s += c[t] * v[t];
      sm.sc[i * L9 + l] = c[9 + l] - s;
    }
  } else if (lane >= 16 && lane < 25) {  // row r of C Ai
    const int r = lane - 16;
    float c[9], y[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) c[t] = sm.sk[(9 + r) * LDH + t];
    vm9(c, sm.ai, y);
#pragma unroll
    for (int j = 0; j < 9; ++j) sm.cai[r * L9 + j] = y[j];
  }
  __syncwarp();
  inv9(sm.sc, L9, sm.si, lane, sm);  // Si
  float hp[20];  // the lane's column of H P again (it is not kept live across the inverses)
#pragma unroll
  for (int q = 0; q < 5; ++q) ld4(sm.hpb + lane * LDH + 4 * q, hp[4 * q], hp[4 * q + 1], hp[4 * q + 2], hp[4 * q + 3]);
  {  // 5. gain row `lane` and dx[lane]
    float u[9], v[9], t1[9], w[9], k1[9], k2[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      u[t] = hp[t];
      v[t] = hp[9 + t];
    }
    vm9(u, sm.aib, t1);
#pragma unroll
    for (int t = 0; t < 9; ++t) t1[t] = v[t] - t1[t];
    vm9(t1, sm.si, w);
    vm9(u, sm.ai, k1);
    vm9(w, sm.cai, k2);
    float k[18], z[18];
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      k[t] = (k1[t] - k2[t]) * gate;
      k[9 + t] = w[t] * gate;
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      z[i] = g_over_an * acc[i] - lin[15 + i] - lin[6 + i];
      z[3 + i] = gyr[i] - lin[18 + i] - lin[9 + i];
    }
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
      for (int i = 0; i < 3; ++i) z[6 + 3 * f + i] = sm.hf[24 * f + 18 + i];
    float dxl = k[0] * z[0];
#pragma unroll
    for (int t = 1; t < 18; ++t) dxl += k[t] * z[t];
    float* o = sm.kg + lane * LDH;
#pragma unroll
    for (int q = 0; q < 4; ++q) st4(o + 4 * q, k[4 * q], k[4 * q + 1], k[4 * q + 2], k[4 * q + 3]);
    st4(o + 16, k[16], k[17], dxl, 0.f);
  }
  __syncwarp();
  float dx[30];  // 6. P -= K (H P), column `lane`; then the retraction
#pragma unroll
  for (int i = 0; i < 30; ++i) {
    float k[20];
#pragma unroll
    for (int q = 0; q < 5; ++q) ld4(sm.kg + i * LDH + 4 * q, k[4 * q], k[4 * q + 1], k[4 * q + 2], k[4 * q + 3]);
    float v = k[0] * hp[0];
#pragma unroll
    for (int t = 1; t < 18; ++t) v += k[t] * hp[t];
    p[i] = p[i] - v;
    dx[i] = k[18];
  }
  retract<27>(rot, lin, dx);
}

}  // namespace lk_warp
