// Slot resolution of the voxel map's insert (find-or-insert with claim
// rounds), for sm_90a.
//
// Replaces the eager claim rounds of core/voxel_map.py (the JAX package's
// _find_or_insert_flat, legkilo_tpu/core/voxel_map.py:415, a series of XLA
// scatters) and computes what ops/claim_slots.claim_plain computes, bit for
// bit:
//
//   for k in 0 .. rounds-1:
//     every active row not yet resolved probes its key's window (the probe
//     slots from the key's hash in its segment, wrapping within it): a row
//     whose key is there resolves to the first slot holding it; a row
//     whose window has an empty slot bids for the first empty one;
//     of the bidders on one slot the highest row wins and writes
//     [key, 1, 0] there; the others try again next round
//   a last probe resolves the rows that won in the last round
//
// Every probe of round k reads the table as round k-1 left it, so a round is
// two launches: probe-and-bid, then award.  A bid is an atomicMax on a
// per-call int32 word a slot (``bid``, zeroed once a call), tagged by round:
// k * M + row + 1, so the highest row of the round wins and a stale bid of
// an earlier round loses to every later one (the wrapper refuses rounds * M
// >= 2^31).  No probe reads a bid, so a probe never sees a half-made claim;
// no slot-sized array is filled a round; a row that is not active, or is
// already resolved, reads one or two flags and leaves, and takes no atomic.
//
// A call is one memset and 2 * rounds + 1 launches, a thread a row in a
// grid-stride loop.  The work that matters is small: the rows still
// unresolved (new keys), each reading its window of probe x 20 B, mostly one
// or two cache lines.  The flags of the other rows (2 B a row a launch) and
// the memset of the bid words (4 B a slot) are the rest of the traffic.
//
// Layout (the map's probe table with its sentinel row, voxel_map.py):
//   ptab [S, 5] int32 key(3), occupied, is_plane; S = miss + 1, the last row
//        the sentinel, which no window reaches and the kernel never writes.
//   keys [M, 3] int32 at (key_sr, key_sc); seg [M] int64 at seg_s (a row's
//   subtable: a fleet's r * L + level); active [M] bool at act_s.
//   slot [M] int64 out (miss where unresolved); ok [M] bool out.
// A probing row whose segment is outside the table traps the kernel, as an
// index outside a CUDA tensor asserts.
//
// Hash: eigen_types.hpp:74-82 on uint32 with wrap-around, the primes of
// keys_kernel (match_geom.cu) and ops/match_geom.hash_keys.

#include "lk_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;   // grid-stride beyond this
constexpr int kPtabW = 5;
constexpr int kOcc = 3;

struct ClaimArgs {
  int* ptab;               // [S, 5]
  const int* keys;         // [M, 3] at (key_sr, key_sc)
  const long long* seg;    // [M] at seg_s
  const bool* active;      // [M] at act_s
  int* bid;                // [S], zero before the first round
  long long* slot;         // [M]
  bool* ok;                // [M]
  long long miss;          // S - 1
  int M, C, probe, nseg, key_sr, key_sc, seg_s, act_s;
};

__device__ __forceinline__ void load_key(const ClaimArgs& a, long long row, int k[3]) {
  const int* kp = a.keys + row * a.key_sr;
#pragma unroll
  for (int i = 0; i < 3; ++i) k[i] = kp[i * a.key_sc];
}

// The first slot of the row's window that holds its key (found), and, when
// none does, the first empty one (empty); -1 for none.
__device__ __forceinline__ void probe_window(const ClaimArgs& a, long long row, const int k[3],
                                             long long& found, long long& empty) {
  const long long s = a.seg[row * a.seg_s];
  if (lk_outside(s, a.nseg)) __trap();
  const uint32_t prime[3] = {73856093u, 471943u, 83492791u};
  uint32_t h = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) h ^= static_cast<uint32_t>(k[i]) * prime[i];
  const uint32_t mask = static_cast<uint32_t>(a.C - 1);
  const uint32_t h0 = h & mask;
  const long long base = s * a.C;
  found = -1;
  empty = -1;
  for (int o = 0; o < a.probe; ++o) {
    const long long idx = base + ((h0 + static_cast<uint32_t>(o)) & mask);
    const int* r = a.ptab + idx * kPtabW;
    if (r[kOcc] > 0) {
      if (r[0] == k[0] && r[1] == k[1] && r[2] == k[2]) {
        found = idx;
        return;
      }
    } else if (empty < 0) {
      empty = idx;
    }
  }
}

// Probe-and-bid of round ``round`` (bidding) or the last probe (not
// bidding).  ``first``: the call's first launch, which sets every row's
// outputs (a row that is not active: slot miss, ok false) and reads no ok.
__global__ void __launch_bounds__(kThreads) claim_probe_kernel(ClaimArgs a, int round, bool bidding,
                                                               bool first) {
  const int tag = round * a.M + 1;
  for (long long row = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; row < a.M;
       row += static_cast<long long>(gridDim.x) * blockDim.x) {
    const bool act = a.active[row * a.act_s];
    if (!act) {
      if (first) {
        a.slot[row] = a.miss;
        a.ok[row] = false;
      }
      continue;
    }
    if (!first && a.ok[row]) continue;
    int k[3];
    load_key(a, row, k);
    long long found, empty;
    probe_window(a, row, k, found, empty);
    if (found >= 0) {
      a.slot[row] = found;
      a.ok[row] = true;
      continue;
    }
    if (first) a.ok[row] = false;
    // Unresolved: the slot it bids for this round (read by the award), or
    // the miss slot; after the last probe, the miss slot.
    if (bidding && empty >= 0) {
      a.slot[row] = empty;
      atomicMax(a.bid + empty, tag + static_cast<int>(row));
    } else {
      a.slot[row] = a.miss;
    }
  }
}

// Award of round ``round``: a bidder whose bid stands writes its key row.
__global__ void __launch_bounds__(kThreads) claim_award_kernel(ClaimArgs a, int round) {
  const int tag = round * a.M + 1;
  for (long long row = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; row < a.M;
       row += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (!a.active[row * a.act_s] || a.ok[row]) continue;
    const long long c = a.slot[row];
    if (c == a.miss || a.bid[c] != tag + static_cast<int>(row)) continue;
    int k[3];
    load_key(a, row, k);
    int* r = a.ptab + c * kPtabW;
    r[0] = k[0];
    r[1] = k[1];
    r[2] = k[2];
    r[kOcc] = 1;
    r[4] = 0;
  }
}

}  // namespace

// The whole series on ``stream``: the memset of the bid words, then rounds x
// (probe-and-bid, award) and the last probe.  Returns the first nonzero
// cudaGetLastError() (launches stop there), or 0.  M >= 1, S >= 2, C a power
// of two with (S - 1) a multiple of C, rounds * M < 2^31: the wrapper
// (ops/claim_slots.claim_call) refuses anything else before calling.
LK_API int claim_slots_launch(void* ptab, const void* keys, const void* seg, const void* active,
                              void* bid, void* slot, void* ok, int M, int S, int C, int probe,
                              int rounds, int key_sr, int key_sc, int seg_s, int act_s,
                              void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  ClaimArgs a{static_cast<int*>(ptab),
              static_cast<const int*>(keys),
              static_cast<const long long*>(seg),
              static_cast<const bool*>(active),
              static_cast<int*>(bid),
              static_cast<long long*>(slot),
              static_cast<bool*>(ok),
              static_cast<long long>(S) - 1,
              M, C, probe, (S - 1) / C, key_sr, key_sc, seg_s, act_s};
  cudaError_t err = cudaMemsetAsync(bid, 0, static_cast<size_t>(S) * sizeof(int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = lk_blocks(M, kThreads) < kMaxBlocks ? lk_blocks(M, kThreads) : kMaxBlocks;
  for (int k = 0; k < rounds; ++k) {
    claim_probe_kernel<<<blocks, kThreads, 0, stream>>>(a, k, true, k == 0);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    claim_award_kernel<<<blocks, kThreads, 0, stream>>>(a, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  claim_probe_kernel<<<blocks, kThreads, 0, stream>>>(a, rounds, false, rounds == 0);
  return static_cast<int>(cudaGetLastError());
}
