// RG-LRU linear recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} + x_t.
//
// Replaces the TPU kernel `rglru_scan_pallas` (_rglru_kernel) of
// src/repro/kernels/rglru_scan/rglru_scan.py.  There, a (B, W/bw, T/bt) grid
// walked T in 128-row blocks sequentially ("arbitrary"), carrying h from one
// grid step to the next in a VMEM scratch vector, with T and W padded to
// multiples of 128 by the wrapper.
//
// What bounds it here: each input is read once and the output written once,
// 3 * B*T*W elements, so the byte bound at the recurrentgemma-2b path's
// (2, 1024, 2560) f32 is 63 MB / 3.35 TB/s = 0.019 ms.  But the recurrence is
// a dependent chain of T steps per channel, and B*W = 5,120 channels fill
// only a few warps per SM: the kernel is bound by the latency of that chain
// and of its loads, several times the byte bound.  A chunked two-pass scan
// (parallel over T) would lift that; this first kernel is the simple one.
//
// What the design does about that:
//  * One thread per (b, w) channel, the threads of a warp on consecutive w,
//    so every time step's loads and stores are coalesced rows.  The carry
//    stays in a register: Hopper blocks run in no order, so the TPU's carry
//    across grid steps becomes one thread's loop over T.
//  * a_t and x_t do not depend on the carry: the next kChunk steps are
//    loaded into registers while the current kChunk are computed, so the
//    chain waits on a load at most once a chunk.
//  * h = __fadd_rn(__fmul_rn(a, h), x): two roundings, never contracted into
//    an FMA (nvcc's default -fmad=true would), so the result equals the plain
//    version (kernels/rglru_scan/ref.py) bitwise, forward and reverse.
//  * `reverse` walks T from the end (h_T = 0): the backward pass runs
//    dh_t = g_t + a_{t+1} * dh_{t+1} through the same kernel.
//  * Nothing is padded in memory: channels past B*W return at once and the
//    tail of T is masked.  f32 and bf16 in and out; bf16 is widened on load
//    and rounded to nearest even on store.

#include <climits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;   // 80 blocks at B*W = 5,120: all SMs get work
constexpr int kChunk = 16;     // time steps loaded ahead of the chain

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ x,
                  T* __restrict__ h, long long channels, int W, int Tn,
                  int reverse) {
  const long long ch = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (ch >= channels) return;
  const long long b = ch / W;
  const long long step = reverse ? -(long long)W : (long long)W;
  const long long first =
      b * Tn * W + (ch - b * W) + (reverse ? (long long)(Tn - 1) * W : 0);

  float an[kChunk], xn[kChunk];
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    const bool in = u < Tn;
    an[u] = in ? to_f(a[first + u * step]) : 0.f;
    xn[u] = in ? to_f(x[first + u * step]) : 0.f;
  }
  float carry = 0.f;
  for (int t0 = 0; t0 < Tn; t0 += kChunk) {
    float ac[kChunk], xc[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      ac[u] = an[u];
      xc[u] = xn[u];
    }
    const long long off = first + (long long)t0 * step;
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {  // the next chunk, ahead of the chain
      if (t0 + kChunk + u < Tn) {
        an[u] = to_f(a[off + (kChunk + u) * step]);
        xn[u] = to_f(x[off + (kChunk + u) * step]);
      }
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      if (t0 + u < Tn) {
        carry = __fadd_rn(__fmul_rn(ac[u], carry), xc[u]);
        h[off + u * step] = from_f<T>(carry);
      }
    }
  }
}

template <typename T>
int launch(const void* a, const void* x, void* h, int B, int Tn, int W,
           int reverse, cudaStream_t stream) {
  const long long channels = (long long)B * W;
  const long long blocks = (channels + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  rglru_scan_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x), static_cast<T*>(h),
      channels, W, Tn, reverse);
  return (int)cudaGetLastError();
}

}  // namespace

// a, x, h: contiguous (B, T, W) of one dtype (f32, or bf16 when is_bf16).
extern "C" int repro_rglru_scan(const void* a, const void* x, void* h,
                                int is_bf16, int B, int Tn, int W,
                                int reverse, void* stream) {
  if (B <= 0 || Tn <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(a, x, h, B, Tn, W, reverse, s);
  return launch<float>(a, x, h, B, Tn, W, reverse, s);
}
