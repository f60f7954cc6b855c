// Position of each MoE assignment inside its expert, and the dispatch slot
// and keep flag that follow from it, for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The reference computes the position as a one-hot
// exclusive cumulative sum (src/repro/models/moe.py::apply_moe), which XLA
// fuses on the TPU.  The same ops in PyTorch (kernels/moe_positions/ref.py)
// run `torch.cumsum` along dim 0 of an int64 (N*k, E) one-hot tensor as an
// outer-dimension scan: parallel over the E columns, serial over the N*k
// rows.  On an H100 that took 3.17 ms a call at granite-moe-1b-a400m's
// (16,384, 32) and 10.9 ms at granite-4.0-h-small's (40,960, 72).
//
// The contract, for assignments i in assignment-major order (token, then
// its k choices, best first), expert e_i in [0, E), the held experts
// [first, first + held) and the capacity cap:
//   pos_i  = #{j < i : e_j = e_i}
//   held_i = first <= e_i < first + held
//   keep_i = pos_i < cap && held_i
//   slot_i = (held_i ? e_i - first : 0) * cap + (keep_i ? pos_i : 0)
// An id outside [0, E), which top-k never gives, counts for no expert and
// reads as not held (slot 0, keep false); the plain version raises there.
//
// What bounds it: 17 bytes an assignment (8 in, 8 + 1 out), 0.70 MB at
// (40,960): 0.21 us at 3.35 TB/s.  Far above that is the order: each
// position counts every earlier assignment to its expert.
//
// What the design does about that: one block of 1,024 threads a tile of
// 1,024 assignments, one a thread, all tiles at once.
//  * A block first counts, per expert, the assignments of every earlier
//    tile (a shared atomicAdd per id: integer counts, the same in any
//    order).  The blocks share nothing, so a call is one launch with no
//    scratch in device memory; the last block reads all N*k ids, from L2
//    (the sort wrote them just before), which sets the call's time.
//  * Then its own tile: each lane sets its bit in table[e][warp] (shared
//    atomicOr) and, after its warp's sync, its rank among the warp's lanes
//    routed to e is the popcount of the bits below its own.  After a
//    barrier, warp w takes experts w, w + 32, ...: lane l holds the
//    popcount of table[x][l], and a shuffle scan over the 32 warps plus the
//    earlier tiles' count of x gives the start of warp l's assignments to
//    x, written over the mask.  After a second barrier, pos =
//    table[e][warp] + rank.
// No atomic decides an order (they count and set bits), so the result is
// one function of the input: bitwise the one-hot cumulative sum.  Rows of
// 33 words keep the scan's accesses (one expert, 32 warps) and a warp's
// (up to 32 experts) on distinct banks.  The shared memory is static,
// 34.8 KB at kMaxExperts = 256; the presets' largest E is 72
// (granite-4.0-h-small).
//
// Design runs on the card (H100 80GB HBM3, 700 W; us a call at the two
// shapes above): one block walking the tiles in order with
// __match_any_sync for the ranks, 25.7 / 79.3 (a chain of ~2 us a tile);
// the same with lane masks, 14.8 / 45.6; a block a tile counting the
// earlier tiles through __match_any_sync, 15.0 / 40.1; this design,
// 5.2 / 8.7 (loads four tiles ahead: 5.0 / 8.5, not worth the code; the
// count loop written over ids with a bounds check, 6.8 / 12.9).

#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;             // one tile: an assignment a thread
constexpr int kWarps = kThreads / 32;
constexpr int kRow = kWarps + 1;           // padded row of one expert
constexpr int kMaxExperts = 256;           // the wrapper's MAX_EXPERTS
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int checked(int64_t e, int num_experts) {
  return (e >= 0 && e < num_experts) ? (int)e : -1;
}

__global__ void __launch_bounds__(kThreads, 1)
moe_positions_kernel(const int64_t* __restrict__ experts,
                     int64_t* __restrict__ slot, bool* __restrict__ keep,
                     int n, int num_experts, int first, int held, int cap) {
  __shared__ unsigned table[kMaxExperts * kRow];
  __shared__ int before[kMaxExperts];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = blockIdx.x * kThreads + tid;
  const int64_t own = i < n ? __ldg(experts + i) : -1;
  for (int k = tid; k < num_experts * kRow; k += kThreads) table[k] = 0;
  for (int k = tid; k < num_experts; k += kThreads) before[k] = 0;
  __syncthreads();

  for (int t = 0; t < (int)blockIdx.x; ++t) {    // earlier tiles are whole
    const int e = checked(__ldg(experts + t * kThreads + tid), num_experts);
    if (e >= 0) atomicAdd(&before[e], 1);
  }

  const int e = checked(own, num_experts);
  if (e >= 0) atomicOr(&table[e * kRow + warp], 1u << lane);
  __syncwarp();
  const unsigned peers = e >= 0 ? table[e * kRow + warp] : 0u;
  const int rank = __popc(peers & ((1u << lane) - 1u));
  __syncthreads();

  for (int x = warp; x < num_experts; x += kWarps) {
    const int c = __popc(table[x * kRow + lane]);
    int incl = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    table[x * kRow + lane] = (unsigned)(before[x] + incl - c);
  }
  __syncthreads();

  if (i < n) {
    const int pos = e >= 0 ? (int)table[e * kRow + warp] + rank : 0;
    const int local = e - first;
    const bool is_held = e >= 0 && local >= 0 && local < held;
    const bool kept = is_held && pos < cap;
    slot[i] = is_held ? (int64_t)local * cap + (kept ? pos : 0) : 0;
    keep[i] = kept;
  }
}

}  // namespace

// slot (int64), keep (bool) of the n assignments' expert ids `experts`
// (int64), all contiguous (n,).  Returns a CUDA error code (0: launched).
extern "C" int repro_moe_positions(const void* experts, void* slot,
                                   void* keep, int n, int num_experts,
                                   int first, int held, int cap,
                                   void* stream) {
  if (n < 0 || n > 0x7fffffff - kThreads || num_experts < 1 ||
      num_experts > kMaxExperts || cap < 0)
    return (int)cudaErrorInvalidValue;
  const int tiles = n > 0 ? (n + kThreads - 1) / kThreads : 1;
  moe_positions_kernel<<<tiles, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(experts), static_cast<int64_t*>(slot),
      static_cast<bool*>(keep), n, num_experts, first, held, cap);
  return (int)cudaGetLastError();
}
