// Un-fused float arithmetic for kernels whose branches hang on an ulp.
//
// lk::F wraps a float; its operators are the round-to-nearest intrinsics, so
// nvcc cannot contract a product and a sum into an FMA.  A kernel written on F
// in the same order of operations as its plain PyTorch version (which rounds
// every product and sum on its own) takes the same branches and, where sqrt,
// division, sin and cos round alike, gives the same bits.
#pragma once

#include <cuda_runtime.h>

namespace lk {

struct F {
  float v;
  __device__ __forceinline__ F() {}
  __device__ __forceinline__ F(float x) : v(x) {}
};

__device__ __forceinline__ F operator+(F a, F b) { return F(__fadd_rn(a.v, b.v)); }
__device__ __forceinline__ F operator-(F a, F b) { return F(__fsub_rn(a.v, b.v)); }
__device__ __forceinline__ F operator*(F a, F b) { return F(__fmul_rn(a.v, b.v)); }
__device__ __forceinline__ F operator/(F a, F b) { return F(__fdiv_rn(a.v, b.v)); }
__device__ __forceinline__ F operator-(F a) { return F(-a.v); }
__device__ __forceinline__ bool operator<(F a, F b) { return a.v < b.v; }
__device__ __forceinline__ bool operator>(F a, F b) { return a.v > b.v; }
__device__ __forceinline__ bool operator>=(F a, F b) { return a.v >= b.v; }
__device__ __forceinline__ F fmax(F a, F b) { return F(fmaxf(a.v, b.v)); }
__device__ __forceinline__ F fmin(F a, F b) { return F(fminf(a.v, b.v)); }
__device__ __forceinline__ F fabs(F a) { return F(fabsf(a.v)); }
__device__ __forceinline__ F fsqrt(F a) { return F(__fsqrt_rn(a.v)); }
__device__ __forceinline__ F fcos(F a) { return F(cosf(a.v)); }
__device__ __forceinline__ void fsincos(F a, F& s, F& c) { sincosf(a.v, &s.v, &c.v); }
__device__ __forceinline__ F sel(bool c, F a, F b) { return c ? a : b; }

}  // namespace lk
