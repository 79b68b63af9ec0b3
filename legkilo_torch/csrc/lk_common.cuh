// Shared helpers for the port's kernels (plain C interface, loaded with ctypes).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define LK_API extern "C" __attribute__((visibility("default")))

// Products and sums that decide a voxel key (a floor of p / size) are kept
// un-fused, so the key computation rounds exactly like the plain PyTorch
// version and the JAX reference: an FMA there can move a point that lies
// within one ulp of a voxel face into the neighbouring voxel.
#define LK_MUL(a, b) __fmul_rn((a), (b))
#define LK_ADD(a, b) __fadd_rn((a), (b))
#define LK_SUB(a, b) __fsub_rn((a), (b))

static inline int lk_blocks(int n, int threads) { return (n + threads - 1) / threads; }

// Whether a row index read from a caller's index tensor lies outside the n
// rows of the table it names.  A kernel traps on one (the launch's stream
// then fails), as PyTorch's indexing asserts on a CUDA tensor.
__device__ __forceinline__ bool lk_outside(long long i, long long n) {
  return static_cast<unsigned long long>(i) >= static_cast<unsigned long long>(n);
}
