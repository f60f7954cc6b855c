// RG-LRU linear recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} + x_t,
// forward or reverse, and its backward fused into one pass.
//
// Replaces the TPU kernel `rglru_scan_pallas` (_rglru_kernel) of
// src/repro/kernels/rglru_scan/rglru_scan.py.  There, a (B, W/bw, T/bt) grid
// walked T in 128-row blocks sequentially ("arbitrary"), carrying h from one
// grid step to the next in a VMEM scratch vector, with T and W padded to
// multiples of 128 by the wrapper.  The reference's backward is the VJP of
// its associative scan; here it is the transposed recurrence, below.
//
// What bounds it here: device-memory bytes.  The forward reads a and x once
// and writes h once, 3 * 4*B*T*W bytes: 63 MB, 0.019 ms at 3.35 TB/s at the
// recurrentgemma-2b path's (2, 1024, 2560) f32.  The backward reads a, g
// and h and writes da and dx, 5 * 4*B*T*W bytes: 0.031 ms.  The dependent
// chain of T steps per channel (an fmul then an fadd a step, about 8 clocks)
// is some 5 us at T = 1,024, well under either.  But B*W = 5,120 channels
// are only 160 warps on 132 SMs, so to stream at the card's rate each warp
// must keep tens of KB of loads in flight (about 1 us of latency times
// 3.35 TB/s spread over 160 warps): a warp that waits on its own loads, as
// registers allow a few KB, is latency-bound at several times the bound.
//
// What the design does about that:
//  * One warp per block, one lane per (b, w) channel: a block takes 32
//    channels of one batch row, B * ceil(W / 32) blocks.  The carry stays
//    in the lane's register; Hopper blocks run in no order, so the TPU's
//    carry across grid steps becomes the warp's loop over T.
//  * A ring of kStages = 4 stages in shared memory, each 8 KB of every
//    input (64 time steps of 32 f32 channels, 128 of bf16), filled with
//    cp.async (16-byte copies where the row pitch and the pointers allow,
//    4-byte copies where not, plain element copies for a bf16 row of odd
//    pitch).  The loads do not depend on the carry, so the warp keeps three
//    stages in flight (48 KB forward, 72 KB backward) while it walks the
//    chain out of shared memory.  Design runs on the card chose the shape:
//    64-step stages beat 16- and 32-step ones with more stages (each stage
//    costs a wait and two warp syncs); 16- or 64-channel blocks and an L2
//    prefetch hint did not help; a walk unrolled 16 steps deep beat 8.
//  * Every step is carry = __fadd_rn(__fmul_rn(a, carry), x) on an fp32
//    carry: two roundings, never contracted into an FMA (nvcc's default
//    -fmad=true would), so the result is bitwise the plain loop's
//    (kernels/rglru_scan/ref.py) in both directions.  A chunked or two-pass
//    associative scan would round in another order; the sequential chain is
//    cheap next to the bytes, so it stays.
//  * `reverse` walks T from the end (h_T = 0); the direction is a template
//    argument, so the walk's indices are constants of the loop.
//  * The backward walks T from the end once: dh_t = a_{t+1} * dh_{t+1} + g_t
//    (a_{t+1} is the `a` the lane read one step earlier, a_T = 0), then
//    dx_t = dh_t and da_t = dh_t * h_{t-1}, with h_{t-1} read ahead through
//    the ring one row lower (h_{-1} = +0).  In bf16 dh is rounded to bf16
//    first and da is the product of the two bf16 values rounded once, as
//    PyTorch's bf16 multiply gives it: bitwise the plain composition (pad,
//    reverse loop, multiply) in both dtypes, with no padded copy of a or h.
//  * Outputs go straight from the lanes: each step's store is one
//    coalesced row of the block's 32 channels.  Nothing is padded in
//    memory.  Lanes past W (the last block of a ragged W) repeat the last
//    channel, reading its words and storing the same values to it, so the
//    walk is one loop with no branch, whose shared loads the compiler runs
//    ahead of the chain (design runs with a store guard a step were far
//    slower).  f32 and bf16 in and out; bf16 is widened on load and rounded
//    to nearest even on store.

#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;          // channels per block: one warp
constexpr int kStages = 4;          // ring depth: kStages - 1 stages in flight
constexpr int kStageBytes = 8192;   // per input per stage

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(gmem), "n"(kBytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Copies `rows` rows of a block's `cols` channels, row pitch `pitch`
// elements, into a [rows][kLanes] tile: kVec bytes a copy by cp.async (16
// or 4), or element by element through registers (kVec == sizeof(T) == 2).
// Copies past `cols` repeat the row's last whole copy, so nothing reads
// past the row and no copy is predicated.
template <typename T, int kVec>
__device__ __forceinline__ void fill(T* dst, const T* src, long long pitch,
                                     int rows, int cols, int lane) {
  constexpr int kPer = kVec / (int)sizeof(T);     // elements a copy
  constexpr int kChunks = kLanes / kPer;          // copies a row
  for (int i = lane; i < rows * kChunks; i += kLanes) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * kPer;
    const T* from = src + r * pitch + min(c, cols - kPer);
    if constexpr (kVec >= 4)
      cp_async<kVec>(dst + r * kLanes + c, from);
    else
      dst[r * kLanes + c] = *from;
  }
}

enum Mode { kForward = 0, kReverse = 1, kBackward = 2 };

// kForward / kReverse: in0 = a, in1 = x, out0 = h.
// kBackward: in0 = a, in1 = g, in2 = h, out0 = da, out1 = dx.
template <typename T, int kVec, int kMode>
__global__ void __launch_bounds__(kLanes)
rglru_scan_kernel(const T* __restrict__ in0, const T* __restrict__ in1,
                  const T* __restrict__ in2, T* __restrict__ out0,
                  T* __restrict__ out1, int Tn, int W) {
  constexpr int kRows = kStageBytes / (kLanes * (int)sizeof(T));
  constexpr int kTile = kRows * kLanes;
  constexpr int kInputs = kMode == kBackward ? 3 : 2;
  constexpr bool kRev = kMode != kForward;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);

  const int lane = threadIdx.x;
  const int w_blocks = (W + kLanes - 1) / kLanes;   // block = (b, w block)
  const int w0 = (blockIdx.x % w_blocks) * kLanes;
  const int cols = min(kLanes, W - w0);
  const int ch = min(lane, cols - 1);     // lanes past W repeat the last
  const long long base =
      (long long)(blockIdx.x / w_blocks) * Tn * W + w0;
  const int n_stages = (Tn + kRows - 1) / kRows;

  // stage s covers steps [lo, hi) of T, the s-th chunk in walk order
  auto bounds = [&](int s, int& lo, int& hi) {
    if (kRev) {
      hi = Tn - s * kRows;
      lo = max(0, hi - kRows);
    } else {
      lo = s * kRows;
      hi = min(Tn, lo + kRows);
    }
  };
  auto fill_stage = [&](int s) {
    int lo, hi;
    bounds(s, lo, hi);
    const int rows = hi - lo;
    T* buf = ring + (s % kStages) * kInputs * kTile;
    fill<T, kVec>(buf, in0 + base + (long long)lo * W, W, rows, cols, lane);
    fill<T, kVec>(buf + kTile, in1 + base + (long long)lo * W, W, rows, cols,
                  lane);
    if constexpr (kMode == kBackward) {   // h a row lower: row r is h_{lo+r-1}
      T* hb = buf + 2 * kTile;
      if (lo == 0) {
        hb[lane] = from_f<T>(0.f);
        fill<T, kVec>(hb + kLanes, in2 + base, W, rows - 1, cols, lane);
      } else {
        fill<T, kVec>(hb, in2 + base + (long long)(lo - 1) * W, W, rows,
                      cols, lane);
      }
    }
  };

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages) fill_stage(s);
    cp_async_commit();
  }
  float carry = 0.f;
  float a_next = 0.f;                     // backward: a_{t+1}, a_T = 0
  for (int s = 0; s < n_stages; ++s) {
    if (s + kStages - 1 < n_stages) fill_stage(s + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();         // stage s has landed
    __syncwarp();

    int lo, hi;
    bounds(s, lo, hi);
    const int rows = hi - lo;
    const T* buf = ring + (s % kStages) * kInputs * kTile + ch;
    int r = kRev ? rows - 1 : 0;
    long long o = base + (long long)(lo + r) * W + ch;    // into the outputs
#pragma unroll 16
    for (int i = 0; i < rows; ++i) {
      const float a = to_f(buf[r * kLanes]);
      const float x = to_f(buf[kTile + r * kLanes]);
      if constexpr (kMode == kBackward) {
        const float h_prev = to_f(buf[2 * kTile + r * kLanes]);
        carry = __fadd_rn(__fmul_rn(a_next, carry), x);
        a_next = a;
        const T dh = from_f<T>(carry);
        out0[o] = from_f<T>(__fmul_rn(to_f(dh), h_prev));
        out1[o] = dh;
      } else {
        carry = __fadd_rn(__fmul_rn(a, carry), x);
        out0[o] = from_f<T>(carry);
      }
      r += kRev ? -1 : 1;
      o += kRev ? -(long long)W : (long long)W;
    }
    __syncwarp();                         // the stage's slot is free to refill
  }
}

template <typename T, int kVec, int kMode>
int launch(const void* in0, const void* in1, const void* in2, void* out0,
           void* out1, int B, int Tn, int W, cudaStream_t stream) {
  constexpr int kSmem =
      kStages * (kMode == kBackward ? 3 : 2) * kStageBytes;
  auto kernel = rglru_scan_kernel<T, kVec, kMode>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)B * ((W + kLanes - 1) / kLanes);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kLanes, kSmem, stream>>>(
      static_cast<const T*>(in0), static_cast<const T*>(in1),
      static_cast<const T*>(in2), static_cast<T*>(out0),
      static_cast<T*>(out1), Tn, W);
  return (int)cudaGetLastError();
}

// The widest copy every row start allows: 16 bytes, else 4, else (bf16 of
// odd pitch) 2, element by element.
template <typename T, int kMode>
int dispatch(const void* const* ptrs, int n_ptrs, const void* in0,
             const void* in1, const void* in2, void* out0, void* out1, int B,
             int Tn, int W, cudaStream_t stream) {
  uintptr_t any = (uintptr_t)W * sizeof(T);
  for (int i = 0; i < n_ptrs; ++i) any |= (uintptr_t)ptrs[i];
  if (any % 16 == 0)
    return launch<T, 16, kMode>(in0, in1, in2, out0, out1, B, Tn, W, stream);
  if (any % 4 == 0)
    return launch<T, 4, kMode>(in0, in1, in2, out0, out1, B, Tn, W, stream);
  if constexpr (sizeof(T) == 2)
    return launch<T, 2, kMode>(in0, in1, in2, out0, out1, B, Tn, W, stream);
  return (int)cudaErrorMisalignedAddress;
}

bool bad_shape(int B, int Tn, int W) {
  return B <= 0 || Tn <= 0 || W <= 0;
}

}  // namespace

// a, x, h: contiguous (B, T, W) of one dtype (f32, or bf16 when is_bf16).
extern "C" int repro_rglru_scan(const void* a, const void* x, void* h,
                                int is_bf16, int B, int Tn, int W,
                                int reverse, void* stream) {
  if (bad_shape(B, Tn, W)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* ptrs[] = {a, x, h};
  if (is_bf16)
    return reverse ? dispatch<__nv_bfloat16, kReverse>(
                         ptrs, 3, a, x, nullptr, h, nullptr, B, Tn, W, s)
                   : dispatch<__nv_bfloat16, kForward>(
                         ptrs, 3, a, x, nullptr, h, nullptr, B, Tn, W, s);
  return reverse ? dispatch<float, kReverse>(ptrs, 3, a, x, nullptr, h,
                                             nullptr, B, Tn, W, s)
                 : dispatch<float, kForward>(ptrs, 3, a, x, nullptr, h,
                                             nullptr, B, Tn, W, s);
}

// The gradient of h = scan(a, x) for the cotangent g: da, dx.  a, h, g, da,
// dx: contiguous (B, T, W) of one dtype.
extern "C" int repro_rglru_scan_backward(const void* a, const void* h,
                                         const void* g, void* da, void* dx,
                                         int is_bf16, int B, int Tn, int W,
                                         void* stream) {
  if (bad_shape(B, Tn, W)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* ptrs[] = {a, h, g, da, dx};
  if (is_bf16)
    return dispatch<__nv_bfloat16, kBackward>(ptrs, 5, a, g, h, da, dx, B,
                                              Tn, W, s);
  return dispatch<float, kBackward>(ptrs, 5, a, g, h, da, dx, B, Tn, W, s);
}
