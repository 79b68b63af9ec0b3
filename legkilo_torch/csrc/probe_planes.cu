// The fused match's probe and plane gather, for sm_90a.
//
// Replaces the torch glue between the keys and select kernels (the JAX
// package's XLA probe, legkilo_tpu/core/filter_deferred.py:390-424) and
// computes what ops/probe_planes.probe_planes_plain computes, bit for bit:
//
//   for each candidate j (own chain's levels, then the neighbour chain's)
//   and row r:
//     walk the probe window of the row's probe start idx0[j, r] inside its
//     own subtable, slot base + ((h0 + o) & (C - 1)) for o = 0 .. probe-1;
//     the lowest offset whose slot is occupied and holds the row's three
//     key words wins (an empty slot does not end the walk: the glue looks
//     past one); found, is_plane (that slot's) and the slot, miss for none;
//     the slot's 31 plane floats upcast exactly, zeros on a miss.
//
// Work: a thread a (candidate, row); the grid is (row tiles of kThreads,
// 2L), so a warp holds 32 consecutive rows of one candidate and every read
// of keys/idx0 and every write of plane_t/flags/slot is one coalesced line.
// The probe rows (20 B) are scattered reads through the read-only path;
// neighbouring rows of a bucket mostly probe the same voxel, so they meet
// in L1/L2.  The plane rows are gathered a warp at a time: for each of its
// 32 rows in turn, lanes 0-30 read the row's 31 floats (one 124 B line or
// two) into a [31][33] shared tile, so each store of the transposed plane_t
// row after it is again one 128 B line.  No atomics, no block barrier (a
// warp's tile is its own; __syncwarp orders it), nothing allocated.
//
// Layout (the fleet's flat map, core/voxel_map.py; the keys kernel's rows,
// ops/match_geom.py):
//   ptab  [S, 5] int32 key(3), occupied, is_plane; S = B*L*C, subtables of C
//   plane [S, 31] T (f32, f16 or bf16 storage)
//   keys  [6L, R] int32 (candidate j's words at rows 3j .. 3j+2)
//   idx0  [2L, R] int32 probe starts, global slots
//   -> plane_t [2L*31, R] f32 (candidate j's field f at row 31j + f),
//      flags [4L, R] f32 (found, then is_plane), slot [L, R] int64 (S for a
//      miss), found [L, R], isp [L, R] bool: the own chain's.
// A probe start outside the table traps the kernel, as an index outside a
// CUDA tensor asserts.

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "lk_common.cuh"

namespace {

constexpr int kThreads = 128;  // four warps, 32 rows each
constexpr int kWarps = kThreads / 32;
constexpr int kPtabW = 5;
constexpr int kOcc = 3;
constexpr int kPlaneW = 31;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__half>(__half x) { return __half2float(x); }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) { return __bfloat162float(x); }

struct ProbeArgs {
  const int* ptab;    // [S, 5]
  const int* keys;    // [6L, R]
  const int* idx0;    // [2L, R]
  float* plane_t;     // [2L*31, R]
  float* flags;       // [4L, R]
  long long* slot;    // [L, R]
  bool* found;        // [L, R]
  bool* isp;          // [L, R]
  int R, S, C, probe, L;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) probe_planes_kernel(ProbeArgs a, const T* __restrict__ plane) {
  __shared__ float tile[kWarps][kPlaneW][33];  // 33: the transposed reads and writes miss no bank
  const int lane = threadIdx.x & 31;
  float(*st)[33] = tile[threadIdx.x >> 5];
  const int j = blockIdx.y;
  const long long R = a.R;
  const long long r = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = r < R;

  long long s = a.S;  // the miss slot
  bool found = false, isp = false;
  if (live) {
    const int k0 = __ldg(a.keys + (3 * j) * R + r);
    const int k1 = __ldg(a.keys + (3 * j + 1) * R + r);
    const int k2 = __ldg(a.keys + (3 * j + 2) * R + r);
    const long long i0 = __ldg(a.idx0 + j * R + r);
    if (lk_outside(i0, a.S)) __trap();
    const long long mask = a.C - 1;
    const long long h0 = i0 & mask;
    const long long base = i0 - h0;
    for (int o = 0; o < a.probe; ++o) {
      const long long idx = base + ((h0 + o) & mask);
      const int* t = a.ptab + idx * kPtabW;
      if (__ldg(t + kOcc) > 0 && __ldg(t) == k0 && __ldg(t + 1) == k1 && __ldg(t + 2) == k2) {
        s = idx;
        found = true;
        isp = __ldg(t + 4) > 0;
        break;
      }
    }
  }

  // The warp's 32 plane rows, a row a turn, into the tile [field][row].
#pragma unroll 8
  for (int i = 0; i < 32; ++i) {
    const long long si = __shfl_sync(kFull, s, i);
    const bool fi = __shfl_sync(kFull, static_cast<int>(found), i) != 0;
    if (lane < kPlaneW) st[lane][i] = fi ? to_f32(plane[si * kPlaneW + lane]) : 0.f;
  }
  __syncwarp();
  if (!live) return;
  float* out = a.plane_t + static_cast<long long>(j) * kPlaneW * R + r;
#pragma unroll
  for (int c = 0; c < kPlaneW; ++c) out[c * R] = st[c][lane];
  a.flags[j * R + r] = found ? 1.f : 0.f;
  a.flags[(2 * a.L + j) * R + r] = isp ? 1.f : 0.f;
  if (j < a.L) {
    a.slot[j * R + r] = s;
    a.found[j * R + r] = found;
    a.isp[j * R + r] = isp;
  }
}

}  // namespace

// plane_dtype: 0 f32, 1 f16, 2 bf16 (voxel_map._STORAGE).  R >= 1, S a
// positive multiple of C, C a power of two, 1 <= probe <= C, 1 <= L <= 4:
// the wrapper (ops/probe_planes.probe_planes_call) refuses anything else
// before calling.
LK_API int probe_planes_launch(const int* ptab, const void* plane, const int* keys, const int* idx0,
                               float* plane_t, float* flags, long long* slot, bool* found, bool* isp,
                               int R, int S, int C, int probe, int L, int plane_dtype, void* stream) {
  if (R <= 0) return 0;
  const ProbeArgs a{ptab, keys, idx0, plane_t, flags, slot, found, isp, R, S, C, probe, L};
  const dim3 grid(lk_blocks(R, kThreads), 2 * L);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (plane_dtype) {
    case 0:
      probe_planes_kernel<float><<<grid, kThreads, 0, st>>>(a, static_cast<const float*>(plane));
      break;
    case 1:
      probe_planes_kernel<__half><<<grid, kThreads, 0, st>>>(a, static_cast<const __half*>(plane));
      break;
    case 2:
      probe_planes_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(a, static_cast<const __nv_bfloat16*>(plane));
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
