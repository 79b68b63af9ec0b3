// Device functions shared by the two ESKF chain kernels (chain_stats.cu,
// chain_points.cu): one thread block of NT threads holds the filter state in
// shared memory and runs, per call, the dual-clock predict of the 30x30
// covariance (eskf.cc:64-89), the structured 6-row IMU update
// (eskf.cc:125-135), the 18-row kinematic update with the nested-Schur 18x18
// inverse (KILO.cc:260-314), or the information-form point update from its
// 6x6 normal equations.  The threads split every product over matrix
// entries; the 3x3 adjugate inverses, exp3 and the state retraction run on
// one thread.  All arithmetic is fp32 on CUDA cores.  Every function is
// called by all threads of the block and ends on a block barrier.  The free
// functions are static: each kernel source compiles its own copy.
#pragma once

#include "lk_common.cuh"

namespace lk_chain {

constexpr int NT = 128;

__device__ __forceinline__ void bmm(float* C, int ldc, const float* A, int lda, const float* B,
                                    int ldb, int M, int K, int N) {
  for (int e = threadIdx.x; e < M * N; e += blockDim.x) {
    const int i = e / N, j = e - (e / N) * N;
    const float* a = A + i * lda;
    float s = a[0] * B[j];
    for (int t = 1; t < K; ++t) s += a[t] * B[t * ldb + j];
    C[i * ldc + j] = s;
  }
  __syncthreads();
}

template <int N>
struct Inv;

// Inverse via the Schur complement of the leading K x K block; the nested
// inverses are Inv<K> and Inv<N-K> (eskf_fused._inv_schur).
template <int N, int K>
__device__ void schur(const float* M, int ldm, float* out, int ldo, float* ws) {
  constexpr int Q = N - K;
  float* Ai = ws;
  float* AiB = Ai + K * K;
  float* CAi = AiB + K * Q;
  float* Sc = CAi + Q * K;
  float* Si = Sc + Q * Q;
  float* AiBSi = Si + Q * Q;
  float* next = AiBSi + K * Q;
  Inv<K>::run(M, ldm, Ai, K, next);
  bmm(AiB, Q, Ai, K, M + K, ldm, K, K, Q);
  bmm(CAi, K, M + K * ldm, ldm, Ai, K, Q, K, K);
  for (int e = threadIdx.x; e < Q * Q; e += blockDim.x) {
    const int i = e / Q, j = e % Q;
    float s = M[(K + i) * ldm] * AiB[j];
    for (int t = 1; t < K; ++t) s += M[(K + i) * ldm + t] * AiB[t * Q + j];
    Sc[e] = M[(K + i) * ldm + K + j] - s;
  }
  __syncthreads();
  Inv<Q>::run(Sc, Q, Si, Q, next);
  bmm(AiBSi, Q, AiB, Q, Si, Q, K, Q, Q);
  for (int e = threadIdx.x; e < N * N; e += blockDim.x) {
    const int i = e / N, j = e % N;
    float v;
    if (i < K && j < K) {
      float s = AiBSi[i * Q] * CAi[j];
      for (int t = 1; t < Q; ++t) s += AiBSi[i * Q + t] * CAi[t * K + j];
      v = Ai[i * K + j] + s;
    } else if (i < K) {
      v = -AiBSi[i * Q + (j - K)];
    } else if (j < K) {
      float s = Si[(i - K) * Q] * CAi[j];
      for (int t = 1; t < Q; ++t) s += Si[(i - K) * Q + t] * CAi[t * K + j];
      v = -s;
    } else {
      v = Si[(i - K) * Q + (j - K)];
    }
    out[i * ldo + j] = v;
  }
  __syncthreads();
}

template <>
struct Inv<3> {
  static __device__ void run(const float* m, int ld, float* out, int ldo, float*) {
    if (threadIdx.x == 0) {
      const float a = m[0], b = m[1], c = m[2];
      const float d = m[ld], e = m[ld + 1], f = m[ld + 2];
      const float g = m[2 * ld], h = m[2 * ld + 1], i = m[2 * ld + 2];
      const float co[9] = {e * i - f * h, c * h - b * i, b * f - c * e,
                           f * g - d * i, a * i - c * g, c * d - a * f,
                           d * h - e * g, b * g - a * h, a * e - b * d};
      const float inv_det = 1.0f / (a * co[0] + b * co[3] + c * co[6]);
      for (int k = 0; k < 9; ++k) out[(k / 3) * ldo + k % 3] = co[k] * inv_det;
    }
    __syncthreads();
  }
};

template <>
struct Inv<6> {
  static __device__ void run(const float* m, int ld, float* out, int ldo, float* ws) {
    schur<6, 3>(m, ld, out, ldo, ws);
  }
};

template <>
struct Inv<9> {
  static __device__ void run(const float* m, int ld, float* out, int ldo, float* ws) {
    schur<9, 3>(m, ld, out, ldo, ws);
  }
};

template <>
struct Inv<18> {
  static __device__ void run(const float* m, int ld, float* out, int ldo, float* ws) {
    schur<18, 9>(m, ld, out, ldo, ws);
  }
};

// ---- single-thread 3x3 helpers (row-major) ----

__device__ __forceinline__ void mm3(const float* a, const float* b, float* out) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      out[3 * i + j] = a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] + a[3 * i + 2] * b[6 + j];
}

__device__ __forceinline__ void skew3(const float* v, float* s) {
  s[0] = 0.f;  s[1] = -v[2]; s[2] = v[1];
  s[3] = v[2]; s[4] = 0.f;   s[5] = -v[0];
  s[6] = -v[1]; s[7] = v[0]; s[8] = 0.f;
}

static __device__ void exp3(const float* w, float* out) {
  const float t2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const float t = sqrtf(t2);
  const bool small = t < 1e-6f;
  const float ts = small ? 1.0f : t;
  const float a = small ? 1.0f - t2 * (1.0f / 6.0f) : sinf(ts) / ts;
  const float b = small ? 0.5f - t2 * (1.0f / 24.0f) : (1.0f - cosf(ts)) / (ts * ts);
  float K[9], KK[9];
  skew3(w, K);
  mm3(K, K, KK);
  for (int k = 0; k < 9; ++k) out[k] = (k % 4 == 0 ? 1.0f : 0.0f) + a * K[k] + b * KK[k];
}

// Chain state and scratch of one thread block: the filter state (cov, rot,
// lin, the two clocks) lives here for the whole scan; the rest is scratch of
// the predict and the three updates.
struct Shared {
  float cov[900];
  float rot[9];
  float lin[27];
  float clk[2];    // last predict, last update
  float blk[27];   // predict blocks: Exp(-dt w) - I, -dt R [a]x, dt R
  float dm[270];
  float pht[540];
  float k[540];
  float hbc[540];
  float hb[324];
  float s[324];
  float si[324];
  float z[18];
  float rr[18];
  float dx[30];
  float m6[36];
  float g6[36];
  float ga[36];
  float gb[6];
  float khp[900];
  float ws[1024];
};

// rot <- rot Exp(dx[0:3]); lin += dx[3:30].  Thread 0 only.
static __device__ void boxplus(Shared& sh, const float* dx) {
  float E[9], R[9];
  exp3(dx, E);
  mm3(sh.rot, E, R);
  for (int k = 0; k < 9; ++k) sh.rot[k] = R[k];
  for (int k = 0; k < 27; ++k) sh.lin[k] += dx[3 + k];
}

// Dual-clock predict; F = I + D with D nonzero in rows 0:9 only, so
// F P F^T = Q1 + (D Q1^T)^T with Q1 = P + D P.
static __device__ void predict(Shared& sh, const float* q, float dtm, float dtc) {
  const int tid = threadIdx.x;
  float* a = sh.blk;
  float* vb = sh.blk + 9;
  float* dr = sh.blk + 18;
  if (tid == 0) {
    const float w[3] = {-dtc * sh.lin[18], -dtc * sh.lin[19], -dtc * sh.lin[20]};
    float E[9], S[9], RS[9];
    exp3(w, E);
    skew3(sh.lin + 15, S);
    mm3(sh.rot, S, RS);
    for (int k = 0; k < 9; ++k) {
      a[k] = E[k] - (k % 4 == 0 ? 1.0f : 0.0f);
      vb[k] = -dtc * RS[k];
      dr[k] = dtc * sh.rot[k];
    }
  }
  __syncthreads();
  float* P = sh.cov;
  for (int e = tid; e < 270; e += NT) {  // D P, rows 0:9
    const int r = e / 30, c = e % 30;
    float v;
    if (r < 3) {
      v = a[3 * r] * P[c] + a[3 * r + 1] * P[30 + c] + a[3 * r + 2] * P[60 + c] + dtc * P[(21 + r) * 30 + c];
    } else if (r < 6) {
      v = dtc * P[(3 + r) * 30 + c];
    } else {
      const int q6 = r - 6;
      v = vb[3 * q6] * P[c] + vb[3 * q6 + 1] * P[30 + c] + vb[3 * q6 + 2] * P[60 + c] +
          dtc * P[(15 + q6) * 30 + c] +
          (dr[3 * q6] * P[540 + c] + dr[3 * q6 + 1] * P[570 + c] + dr[3 * q6 + 2] * P[600 + c]);
    }
    sh.dm[e] = v;
  }
  __syncthreads();
  for (int e = tid; e < 270; e += NT) P[e] += sh.dm[e];  // Q1
  __syncthreads();
  for (int e = tid; e < 270; e += NT) {  // (D Q1^T)[r][c] = D_r . Q1_c
    const int r = e / 30, c = e % 30;
    const float* qc = P + c * 30;
    float v;
    if (r < 3) {
      v = a[3 * r] * qc[0] + a[3 * r + 1] * qc[1] + a[3 * r + 2] * qc[2] + dtc * qc[21 + r];
    } else if (r < 6) {
      v = dtc * qc[3 + r];
    } else {
      const int q6 = r - 6;
      v = vb[3 * q6] * qc[0] + vb[3 * q6 + 1] * qc[1] + vb[3 * q6 + 2] * qc[2] + dtc * qc[15 + q6] +
          (dr[3 * q6] * qc[18] + dr[3 * q6 + 1] * qc[19] + dr[3 * q6 + 2] * qc[20]);
    }
    sh.dm[e] = v;
  }
  __syncthreads();
  for (int e = tid; e < 270; e += NT) {
    const int r = e / 30, c = e % 30;
    P[c * 30 + r] += sh.dm[e];
  }
  __syncthreads();
  if (tid < 30) P[tid * 31] += (dtc * dtc) * q[tid];
  if (tid == 0) {  // mean over dt_mean: x <- x boxplus f(x) dt (eskf.cc:64-70)
    const float* l = sh.lin;
    float dx[30];
    for (int i = 0; i < 3; ++i) {
      const float acc_w = sh.rot[3 * i] * l[15] + sh.rot[3 * i + 1] * l[16] + sh.rot[3 * i + 2] * l[17] + l[12 + i];
      dx[i] = dtm * l[18 + i];
      dx[3 + i] = dtm * l[3 + i];
      dx[6 + i] = dtm * acc_w;
    }
    for (int i = 9; i < 30; ++i) dx[i] = 0.f;
    boxplus(sh, dx);
  }
  __syncthreads();
}

static __device__ void update_imu(Shared& sh, const float* acc, const float* gyr, const float* r6,
                           float g_over_an, float gate) {
  const int tid = threadIdx.x;
  float* P = sh.cov;
  float* hp = sh.hbc;  // [6][30]
  for (int e = tid; e < 180; e += NT) {
    const int i = e / 6, j = e % 6;
    sh.pht[e] = P[i * 30 + 9 + j] + P[i * 30 + 18 + j];
    hp[j * 30 + i] = P[(9 + j) * 30 + i] + P[(18 + j) * 30 + i];
  }
  if (tid < 3) {
    sh.z[tid] = g_over_an * acc[tid] - sh.lin[15 + tid] - sh.lin[6 + tid];
    sh.z[3 + tid] = gyr[tid] - sh.lin[18 + tid] - sh.lin[9 + tid];
  }
  __syncthreads();
  for (int e = tid; e < 36; e += NT) {
    const int i = e / 6, j = e % 6;
    sh.s[e] = sh.pht[(9 + i) * 6 + j] + sh.pht[(18 + i) * 6 + j] + (i == j ? r6[j] : 0.f);
  }
  __syncthreads();
  Inv<6>::run(sh.s, 6, sh.si, 6, sh.ws);
  for (int e = tid; e < 180; e += NT) {
    const int i = e / 6, j = e % 6;
    float s = sh.pht[i * 6] * sh.si[j];
    for (int t = 1; t < 6; ++t) s += sh.pht[i * 6 + t] * sh.si[t * 6 + j];
    sh.k[e] = s * gate;
  }
  __syncthreads();
  if (tid < 30) {
    float s = sh.k[tid * 6] * sh.z[0];
    for (int t = 1; t < 6; ++t) s += sh.k[tid * 6 + t] * sh.z[t];
    sh.dx[tid] = s;
  }
  __syncthreads();
  if (tid == 0) boxplus(sh, sh.dx);
  for (int e = tid; e < 900; e += NT) {
    const int i = e / 30, j = e % 30;
    float s = sh.k[i * 6] * hp[j];
    for (int t = 1; t < 6; ++t) s += sh.k[i * 6 + t] * hp[t * 30 + j];
    P[e] = P[e] - s;
  }
  __syncthreads();
}

// Full-state index of active column t of the kinematic H:
// [rot 0:3, vel 6:9, ba 9:12, bw 12:15, imu_a 18:21, imu_w 21:24].
__device__ __forceinline__ int act(int t) { return t < 3 ? t : (t < 12 ? t + 3 : t + 6); }

static __device__ void update_kin(Shared& sh, const float* acc, const float* gyr, const float* fp,
                           const float* fv, const float* ct, const float* r6, float kin_noise,
                           float g_over_an, float gate) {
  const int tid = threadIdx.x;
  float* P = sh.cov;
  for (int e = tid; e < 324; e += NT) sh.hb[e] = 0.f;
  __syncthreads();
  if (tid == 0) {
    float* hb = sh.hb;
    const float* l = sh.lin;
    for (int i = 0; i < 3; ++i) {
      sh.z[i] = g_over_an * acc[i] - l[15 + i] - l[6 + i];
      sh.z[3 + i] = gyr[i] - l[18 + i] - l[9 + i];
      hb[i * 18 + 6 + i] = 1.f;         // ba
      hb[i * 18 + 12 + i] = 1.f;        // imu_a
      hb[(3 + i) * 18 + 9 + i] = 1.f;   // bw
      hb[(3 + i) * 18 + 15 + i] = 1.f;  // imu_w
    }
    for (int i = 0; i < 6; ++i) sh.rr[i] = r6[i];
    const float* w = l + 18;
    for (int f = 0; f < 4; ++f) {
      const float c = ct[f];
      const float* p = fp + 3 * f;
      const float* v = fv + 3 * f;
      const float wxp_v[3] = {w[1] * p[2] - w[2] * p[1] + v[0], w[2] * p[0] - w[0] * p[2] + v[1],
                              w[0] * p[1] - w[1] * p[0] + v[2]};
      float S1[9], S2[9], HR[9], HW[9];
      skew3(wxp_v, S1);
      skew3(p, S2);
      mm3(sh.rot, S1, HR);
      mm3(sh.rot, S2, HW);
      for (int i = 0; i < 3; ++i) {
        const int row = 6 + 3 * f + i;
        for (int j = 0; j < 3; ++j) {
          hb[row * 18 + j] = -HR[3 * i + j] * c;
          hb[row * 18 + 15 + j] = -HW[3 * i + j] * c;
        }
        hb[row * 18 + 3 + i] = c;
        const float rwv = sh.rot[3 * i] * wxp_v[0] + sh.rot[3 * i + 1] * wxp_v[1] + sh.rot[3 * i + 2] * wxp_v[2];
        sh.z[row] = (-l[3 + i] - rwv) * c;
        sh.rr[row] = c > 0.5f ? kin_noise : 1.0f;
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < 540; e += NT) {  // P H^T over the active columns
    const int i = e / 18, j = e % 18;
    float s = P[i * 30 + act(0)] * sh.hb[j * 18];
    for (int t = 1; t < 18; ++t) s += P[i * 30 + act(t)] * sh.hb[j * 18 + t];
    sh.pht[e] = s;
  }
  __syncthreads();
  for (int e = tid; e < 324; e += NT) {  // H P H^T + R
    const int i = e / 18, j = e % 18;
    float s = sh.hb[i * 18] * sh.pht[act(0) * 18 + j];
    for (int t = 1; t < 18; ++t) s += sh.hb[i * 18 + t] * sh.pht[act(t) * 18 + j];
    sh.s[e] = s + (i == j ? sh.rr[j] : 0.f);
  }
  for (int e = tid; e < 540; e += NT) {  // H P over the active rows
    const int i = e / 30, j = e % 30;
    float s = sh.hb[i * 18] * P[act(0) * 30 + j];
    for (int t = 1; t < 18; ++t) s += sh.hb[i * 18 + t] * P[act(t) * 30 + j];
    sh.hbc[e] = s;
  }
  __syncthreads();
  Inv<18>::run(sh.s, 18, sh.si, 18, sh.ws);
  for (int e = tid; e < 540; e += NT) {
    const int i = e / 18, j = e % 18;
    float s = sh.pht[i * 18] * sh.si[j];
    for (int t = 1; t < 18; ++t) s += sh.pht[i * 18 + t] * sh.si[t * 18 + j];
    sh.k[e] = s * gate;
  }
  __syncthreads();
  if (tid < 30) {
    float s = sh.k[tid * 18] * sh.z[0];
    for (int t = 1; t < 18; ++t) s += sh.k[tid * 18 + t] * sh.z[t];
    sh.dx[tid] = s;
  }
  __syncthreads();
  if (tid == 0) boxplus(sh, sh.dx);
  for (int e = tid; e < 900; e += NT) {
    const int i = e / 30, j = e % 30;
    float s = sh.k[i * 18] * sh.hbc[j];
    for (int t = 1; t < 18; ++t) s += sh.k[i * 18 + t] * sh.hbc[t * 30 + j];
    P[e] = P[e] - s;
  }
  __syncthreads();
}

// Information-form update from the 6x6 normal equations (eskf.update_by_points):
// G = (I + A P66)^-1, dx = P[:,0:6] G b, P -= P[:,0:6] (G A) P[0:6,:].
// A[i][j] at A[i * lda + j], b[i] at b[i * ldb].  A = 0, b = 0 is an exact no-op.
static __device__ void info_update(Shared& sh, const float* A, int lda, const float* b, int ldb) {
  const int tid = threadIdx.x;
  float* P = sh.cov;
  for (int e = tid; e < 36; e += NT) {  // I + A P66
    const int i = e / 6, j = e % 6;
    float s = A[i * lda] * P[j];
    for (int t = 1; t < 6; ++t) s += A[i * lda + t] * P[t * 30 + j];
    sh.m6[e] = (i == j ? 1.0f : 0.0f) + s;
  }
  __syncthreads();
  Inv<6>::run(sh.m6, 6, sh.g6, 6, sh.ws);
  for (int e = tid; e < 42; e += NT) {  // G A (36) and G b (6)
    if (e < 36) {
      const int i = e / 6, j = e % 6;
      float s = sh.g6[i * 6] * A[j];
      for (int t = 1; t < 6; ++t) s += sh.g6[i * 6 + t] * A[t * lda + j];
      sh.ga[e] = s;
    } else {
      const int i = e - 36;
      float s = sh.g6[i * 6] * b[0];
      for (int t = 1; t < 6; ++t) s += sh.g6[i * 6 + t] * b[t * ldb];
      sh.gb[i] = s;
    }
  }
  __syncthreads();
  for (int e = tid; e < 180; e += NT) {  // P[:, 0:6] G A
    const int i = e / 6, j = e % 6;
    float s = P[i * 30] * sh.ga[j];
    for (int t = 1; t < 6; ++t) s += P[i * 30 + t] * sh.ga[t * 6 + j];
    sh.k[e] = s;
  }
  if (tid < 30) {
    float s = P[tid * 30] * sh.gb[0];
    for (int t = 1; t < 6; ++t) s += P[tid * 30 + t] * sh.gb[t];
    sh.dx[tid] = s;
  }
  __syncthreads();
  for (int e = tid; e < 900; e += NT) {
    const int i = e / 30, j = e % 30;
    float s = sh.k[i * 6] * P[j];
    for (int t = 1; t < 6; ++t) s += sh.k[i * 6 + t] * P[t * 30 + j];
    sh.khp[e] = s;
  }
  __syncthreads();
  if (tid == 0) boxplus(sh, sh.dx);
  for (int e = tid; e < 900; e += NT) P[e] = P[e] - sh.khp[e];
  __syncthreads();
}

// ---- the parts of the bucket walk that both chain kernels share ----

// The scan-start state and the parameter vector into shared memory.
// prm [40]: q_diag(30) imu_r(6) g_over_acc_norm kin_noise pad(2).
static __device__ void load_state(Shared& sh, float* prm, const float* params, const float* clocks,
                                  const float* rot0, const float* lin0, const float* cov0) {
  const int tid = threadIdx.x;
  for (int e = tid; e < 900; e += NT) sh.cov[e] = cov0[e];
  if (tid < 9) sh.rot[tid] = rot0[tid];
  if (tid < 27) sh.lin[tid] = lin0[tid];
  if (tid < 2) sh.clk[tid] = clocks[tid];
  if (tid < 40) prm[tid] = params[tid];
  __syncthreads();
}

// Bucket b's K event slots: predict to the event, then the IMU or the
// kinematic update, gated per slot; a valid event moves both clocks.
static __device__ void run_events(Shared& sh, const float* prm, int b, int kmax,
                                  const float* etime, const float* egate, const float* eacc,
                                  const float* egyr, const float* efp, const float* efv,
                                  const float* ect, int use_kin) {
  const float* q = prm;
  const float* r6 = prm + 30;
  const float g_over_an = prm[36], kin_noise = prm[37];
  for (int k = 0; k < kmax; ++k) {
    const int ev = b * kmax + k;
    const float t = etime[ev], g = egate[ev];
    const float lp = sh.clk[0], lu = sh.clk[1];
    predict(sh, q, (t - lp) * g, (t - lu) * g);
    if (use_kin) {
      update_kin(sh, eacc + 3 * ev, egyr + 3 * ev, efp + 12 * ev, efv + 12 * ev, ect + 4 * ev, r6,
                 kin_noise, g_over_an, g);
    } else {
      update_imu(sh, eacc + 3 * ev, egyr + 3 * ev, r6, g_over_an, g);
    }
    if (threadIdx.x == 0 && g > 0.5f) {
      sh.clk[0] = t;
      sh.clk[1] = t;
    }
    __syncthreads();
  }
}

// End of bucket b: the clocks (a valid bucket moves the predict clock, one
// that also updated moves the update clock), then the bucket's outputs.
static __device__ void finish_bucket(Shared& sh, int b, float t, float g, bool did, float nm,
                                     float* orot, float* opos, float* orotcov, float* oposcov,
                                     float* onm) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    if (g > 0.5f) sh.clk[0] = t;
    if (g > 0.5f && did) sh.clk[1] = t;
    onm[b] = nm;
  }
  if (tid < 9) {
    orot[9 * b + tid] = sh.rot[tid];
    orotcov[9 * b + tid] = sh.cov[(tid / 3) * 30 + tid % 3];
    oposcov[9 * b + tid] = sh.cov[(3 + tid / 3) * 30 + 3 + tid % 3];
  }
  if (tid < 3) opos[3 * b + tid] = sh.lin[tid];
  __syncthreads();
}

static __device__ void store_final(const Shared& sh, float* frot, float* flin, float* fcov,
                                   float* fclocks) {
  const int tid = threadIdx.x;
  for (int e = tid; e < 900; e += NT) fcov[e] = sh.cov[e];
  if (tid < 9) frot[tid] = sh.rot[tid];
  if (tid < 27) flin[tid] = sh.lin[tid];
  if (tid < 2) fclocks[tid] = sh.clk[tid];
}

}  // namespace lk_chain
