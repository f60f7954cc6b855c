// Gradient compression for Hopper (sm_90a): int8 quantize / dequantize and
// top-k sparsify / densify, the four kernels of the compressed push.
//
// Replaces the TPU kernels of src/repro/kernels/compress/compress.py:
//   quantize_pack_pallas     (_quantize_pack_kernel, index maps
//                             _pack_index_out / _scale_index_out)
//   dequantize_unpack_pallas (_dequantize_unpack_kernel, _scale_index_in)
//   sparsify_pallas          (_sparsify_kernel)
//   densify_pallas           (_densify_kernel)
// There, a (K, Lmax // TILE) grid walked one 512-element tile per program
// through VMEM, out-of-range tiles were redirected to a scratch tile, and the
// top-k gather / scatter were one-hot masked sums over a whole row.
//
// What bounds them here: device-memory bytes.  Quantize reads 4 bytes and
// writes 1 byte per element plus one f32 scale per tile (~5.008 B/elem);
// dequantize the reverse.  Sparsify reads the chosen values and the indices
// and writes the values; densify writes the dense row (zeroed by the
// wrapper) and reads the pairs.  None of them does enough arithmetic to
// matter.
//
// What the designs do about that:
// * quantize: one 128-thread block per tile, one float4 per thread; the
//   block finds its row in a small device table of per-row tile offsets (a
//   binary search over K + 1 entries), so no grid slot is wasted on the
//   ragged rows' padding and nothing is redirected.  The tile's absmax is a
//   warp-shuffle max then a 4-warp max in shared memory; NaN propagates as
//   jnp.max does (fmaxf alone would drop it).  The arithmetic is the
//   reference's as it trains (under jit): inv = 127 / absmax by IEEE
//   division (nvcc's default -prec-div=true; no fast math), q = round half
//   to even, saturated to int8 with NaN -> 0 (XLA's conversion), and
//   scale = absmax * fp32(1/127), since XLA rewrites the division by the
//   constant into that product.
// * dequantize: one thread per 4 output elements of (K, lmax), char4 in,
//   float4 out, zero past each row's aligned length.  For the error-feedback
//   push it also writes row 0's residual, corrected - q * scale rounded once
//   (fmaf), which is how XLA computes the reference's `corrected -
//   compressed` under jit: it fuses the subtraction with the dequantizing
//   product.  Rounding the product first would differ in most elements.
// * sparsify: a direct gather.  The one-hot form would cost O(kmax * Lmax)
//   operations (10^14 at the embedding's row); the gather is exact because
//   top-k indices are unique apart from -1.  Its byte bound counts 12 B a
//   slot (index, value, output), but each gathered 4-byte value lies in its
//   own 32-byte sector of a row far larger than L2, so DRAM moves at least
//   40 B a slot: the gather is bound by random sector reads.  So: one block
//   row per segment row (blockIdx.y: no 64-bit division per slot); a warp
//   takes 32 * 4 consecutive slots and each lane 4 of them, 32 apart, so a
//   lane keeps 4 independent gathers in flight while every warp
//   instruction loads 32 consecutive indices, gathers from one narrow
//   window of the sorted row and stores 128 contiguous bytes.  Gathers are
//   non-allocating loads (ld.global.nc.L1::no_allocate: each sector is used
//   once).  4 consecutive slots a lane (one int4 index load, one float4
//   store) was slower in design runs on the card: each warp instruction
//   then spans 4x the row, which we take to open DRAM pages for fewer
//   sectors.  A -1 or out-of-range slot loads nothing and gives +0.0; a
//   chosen -0.0 keeps its sign, as the plain version does.
// * densify: one thread per (row, slot) storing 0.0f + v into the zeroed
//   row.  The add is deliberate: the reference's .at[].add into zeros turns
//   a chosen -0.0 into +0.0, and so does __fadd_rn(0.0f, v); a plain store
//   would keep the sign.  Indices out of [0, lmax) (the -1 padding) drop.
// All four are exact, so the results are bitwise the plain versions'.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 512;
constexpr int kQuantThreads = kTile / 4;   // one float4 per thread
constexpr int kThreads = 256;

__device__ __forceinline__ int find_row(const long long* offsets, int k_count,
                                        long long t) {
  // largest k with offsets[k] <= t (offsets ascending, offsets[0] == 0)
  int lo = 0, hi = k_count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (offsets[mid] <= t) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ signed char quantize_one(float x, float inv) {
  const float r = rintf(x * inv);           // round half to even
  if (isnan(r)) return 0;                   // XLA: NaN -> 0
  return (signed char)(int)fminf(fmaxf(r, -128.0f), 127.0f);
}

__global__ void __launch_bounds__(kQuantThreads)
quantize_pack_kernel(const float* __restrict__ seg, long long lmax,
                     const long long* __restrict__ tile_offsets, int k_count,
                     signed char* __restrict__ payload,
                     float* __restrict__ scales) {
  const long long t = blockIdx.x;           // global tile
  const int k = find_row(tile_offsets, k_count, t);
  const long long tin = t - tile_offsets[k];
  const float4 v = reinterpret_cast<const float4*>(
      seg + (long long)k * lmax + tin * kTile)[threadIdx.x];

  float m = fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                  fmaxf(fabsf(v.z), fabsf(v.w)));
  int has_nan = isnan(v.x) || isnan(v.y) || isnan(v.z) || isnan(v.w);
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  has_nan = __any_sync(0xffffffffu, has_nan);

  __shared__ float warp_max[kQuantThreads / 32];
  __shared__ int warp_nan[kQuantThreads / 32];
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    warp_max[warp] = m;
    warp_nan[warp] = has_nan;
  }
  __syncthreads();
  float absmax = warp_max[0];
  int any_nan = warp_nan[0];
  for (int w = 1; w < kQuantThreads / 32; ++w) {
    absmax = fmaxf(absmax, warp_max[w]);
    any_nan |= warp_nan[w];
  }
  if (any_nan) absmax = __int_as_float(0x7fffffff);

  const float inv = absmax > 0.0f ? 127.0f / absmax : 0.0f;
  char4 q;
  q.x = quantize_one(v.x, inv);
  q.y = quantize_one(v.y, inv);
  q.z = quantize_one(v.z, inv);
  q.w = quantize_one(v.w, inv);
  reinterpret_cast<char4*>(payload + t * kTile)[threadIdx.x] = q;
  if (threadIdx.x == 0) scales[t] = absmax * (1.0f / 127.0f);
}

__global__ void __launch_bounds__(kThreads)
dequantize_unpack_kernel(const signed char* __restrict__ payload,
                         const float* __restrict__ scales,
                         const long long* __restrict__ offsets, long long lmax,
                         float* __restrict__ out,
                         const float* __restrict__ corrected,
                         float* __restrict__ residual, long long n_residual) {
  const int k = blockIdx.y;
  const long long j = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (j >= lmax) return;
  const long long off = offsets[k];
  const long long n = offsets[k + 1] - off;
  float4 r = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (j < n) {
    const char4 q = *reinterpret_cast<const char4*>(payload + off + j);
    const float s = scales[(off + j) / kTile];
    r = make_float4((float)q.x * s, (float)q.y * s, (float)q.z * s,
                    (float)q.w * s);
    if (residual != nullptr && k == 0) {
      const float qs[4] = {(float)q.x, (float)q.y, (float)q.z, (float)q.w};
      for (int e = 0; e < 4 && j + e < n_residual; ++e)
        residual[j + e] = fmaf(-qs[e], s, corrected[j + e]);
    }
  }
  *reinterpret_cast<float4*>(out + (long long)k * lmax + j) = r;
}

constexpr int kGathers = 4;                 // sparsify: slots a lane

__device__ __forceinline__ float gather(const float* row, int i,
                                        long long lmax) {
  float v = 0.0f;
  if (i >= 0 && i < lmax)
    asm volatile("ld.global.nc.L1::no_allocate.f32 %0, [%1];"
                 : "=f"(v) : "l"(row + i));
  return v;
}

// Segment rows by blockIdx.y (striding by gridDim.y, so any K); a warp
// takes 32 * kGathers consecutive slots of a row, lane l the slots l,
// l + 32, ... of them.
__global__ void __launch_bounds__(kThreads)
sparsify_kernel(const float* __restrict__ seg, long long lmax,
                const int* __restrict__ idx, long long kmax, int k_count,
                float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * kThreads * kGathers;
  for (int k = blockIdx.y; k < k_count; k += gridDim.y) {
    const float* row = seg + (long long)k * lmax;
    const int* ri = idx + (long long)k * kmax;
    float* ro = out + (long long)k * kmax;
    for (long long s0 = ((long long)blockIdx.x * kThreads +
                         (threadIdx.x & ~31)) * kGathers + (threadIdx.x & 31);
         s0 < kmax; s0 += stride) {
      int i[kGathers];
#pragma unroll
      for (int u = 0; u < kGathers; ++u)
        i[u] = s0 + 32 * u < kmax ? ri[s0 + 32 * u] : -1;
      float v[kGathers];
#pragma unroll
      for (int u = 0; u < kGathers; ++u) v[u] = gather(row, i[u], lmax);
#pragma unroll
      for (int u = 0; u < kGathers; ++u)
        if (s0 + 32 * u < kmax) ro[s0 + 32 * u] = v[u];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
densify_kernel(const float* __restrict__ vals, const int* __restrict__ idx,
               long long kmax, long long slots, long long lmax,
               float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       s < slots; s += stride) {
    const long long i = idx[s];
    if (i >= 0 && i < lmax)
      out[(s / kmax) * lmax + i] = __fadd_rn(0.0f, vals[s]);
  }
}

int grid_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 1048576) blocks = 1048576;   // grid-stride beyond this
  return (int)blocks;
}

}  // namespace

// seg: (K, lmax) f32; tile_offsets: device int64 (K + 1,) running tile
// counts of the aligned lengths; payload (ntiles * 512,) int8, scales
// (ntiles,) f32.
extern "C" int repro_quantize_pack(const void* seg, long long lmax,
                                   const void* tile_offsets, int k_count,
                                   long long ntiles, void* payload,
                                   void* scales, void* stream) {
  if (ntiles <= 0) return 0;
  quantize_pack_kernel<<<(unsigned)ntiles, kQuantThreads, 0,
                         (cudaStream_t)stream>>>(
      static_cast<const float*>(seg), lmax,
      static_cast<const long long*>(tile_offsets), k_count,
      static_cast<signed char*>(payload), static_cast<float*>(scales));
  return (int)cudaGetLastError();
}

// offsets: device int64 (K + 1,) running element counts; out (K, lmax) f32.
// With residual non-null, also residual[i] = corrected[i] - q[i] * scale
// (one rounding) for i < n_residual <= the first row's aligned length.
extern "C" int repro_dequantize_unpack(const void* payload, const void* scales,
                                       const void* offsets, int k_count,
                                       long long lmax, void* out,
                                       const void* corrected, void* residual,
                                       long long n_residual, void* stream) {
  if (k_count <= 0 || lmax <= 0) return 0;
  const long long groups = lmax / 4;
  dim3 grid((unsigned)((groups + kThreads - 1) / kThreads), k_count);
  dequantize_unpack_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const signed char*>(payload),
      static_cast<const float*>(scales),
      static_cast<const long long*>(offsets), lmax, static_cast<float*>(out),
      static_cast<const float*>(corrected), static_cast<float*>(residual),
      n_residual);
  return (int)cudaGetLastError();
}

// seg (K, lmax) f32, idx (K, kmax) int32 -> out (K, kmax) f32.
extern "C" int repro_sparsify(const void* seg, long long lmax, const void* idx,
                              long long kmax, int k_count, void* out,
                              void* stream) {
  if (kmax <= 0 || k_count <= 0) return 0;
  dim3 grid(grid_for((kmax + kGathers - 1) / kGathers),
            k_count < 65535 ? k_count : 65535);
  sparsify_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(seg), lmax, static_cast<const int*>(idx), kmax,
      k_count, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// vals (K, kmax) f32, idx (K, kmax) int32 -> out (K, lmax) f32, which the
// caller has zeroed.
extern "C" int repro_densify(const void* vals, const void* idx, long long kmax,
                             int k_count, long long lmax, void* out,
                             void* stream) {
  const long long slots = kmax * k_count;
  if (slots <= 0) return 0;
  densify_kernel<<<grid_for(slots), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(vals), static_cast<const int*>(idx), kmax,
      slots, lmax, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
