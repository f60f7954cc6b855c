// AdamW's update of one flat float32 buffer in a single pass, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel.  The reference writes the update as elementwise
// jnp ops (src/repro/optim/optimizers.py::adamw), which XLA fuses into one
// loop on the TPU.  The same ops in PyTorch (kernels/adamw/ref.py, the
// port's loop) run as 14 elementwise kernels a buffer, each reading and
// writing whole buffers: about 32 four-byte accesses a parameter.
//
// What bounds it: bytes.  Each element reads g, p, m and v once and writes
// p, m and v once, 28 bytes, for ~15 float operations: 2.82 GB at
// granite-3-2b's embedding buffer (100,669,440 entries), 0.84 ms at
// 3.35 TB/s.
//
// The contract is the plain loop's result, bit for bit, on the card.  Each
// rounding of the loop stays, in its order, with the intrinsics that forbid
// nvcc to contract a multiply and an add the loop keeps apart:
//   m = m * b1 + g * (1 - b1)               two products, one sum
//   v = v * b2 + (g * g) * (1 - b2)         g.square() is g * g
//   d = (m * inv_b1c) / (sqrt(v * inv_b2c) + eps)
//   d = fma(weight_decay, p, d)             add_(p, alpha=weight_decay)
//   p = p - d * lr
// as PyTorch's CUDA kernels apply a Python scalar: converted to float32
// first (1 - b1 is taken in double, then converted); a tensor divided by a
// CPU scalar is multiplied by the float32 reciprocal of it, which the
// wrapper computes on the host as PyTorch does (BinaryDivTrueKernel.cu);
// add with alpha is a + alpha * b, which nvcc contracts into one fma.  The
// bitwise tests on the card (tests/test_torch_gpu.py) hold each point.
//
// What the design does about the bound: one thread a float4 of each
// buffer, a block a 1,024 elements, the whole buffer in one grid.  Where
// the four buffers are 16-byte aligned, each thread loads a float4 of g, p,
// m and v (64 bytes in flight), computes, and stores p, m and v; the n % 4
// elements after the last float4 go one a thread to the threads after it.
// Otherwise every element goes one a thread.  No scratch, no host sync: one
// launch a buffer on the caller's stream.
//
// Design runs on the card (H100 80GB HBM3, 700 W; share of the 28-byte
// bound at 100,669,440 / 411,041,792 entries, 10 samples of 5 x 10
// launches): a grid-stride loop over the blocks resident at once, two
// float4s of each buffer a thread in flight, streaming cache hints
// (__ldcs / __stcs), 83.1 / 83.3%; the same without hints 84.2 / 84.6%;
// one or four float4s a thread, a 4x grid or 512 threads a block, 83.4-
// 84.9%; this design with the hints, 87.9 / 89.0%; this design,
// 89.5 / 90.1%.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Scalars {
  float b1, one_minus_b1, b2, one_minus_b2;
  float inv_b1c, inv_b2c, eps, lr, weight_decay;
  int decay;                                  // weight_decay != 0
};

__device__ __forceinline__ void update(float g, float& p, float& m, float& v,
                                       const Scalars& s) {
  m = __fadd_rn(__fmul_rn(m, s.b1), __fmul_rn(g, s.one_minus_b1));
  v = __fadd_rn(__fmul_rn(v, s.b2),
                __fmul_rn(__fmul_rn(g, g), s.one_minus_b2));
  float d = __fdiv_rn(__fmul_rn(m, s.inv_b1c),
                      __fadd_rn(__fsqrt_rn(__fmul_rn(v, s.inv_b2c)), s.eps));
  if (s.decay) d = __fmaf_rn(s.weight_decay, p, d);
  p = __fsub_rn(p, __fmul_rn(d, s.lr));
}

__device__ __forceinline__ void update_at(const float* __restrict__ g,
                                          float* __restrict__ p,
                                          float* __restrict__ m,
                                          float* __restrict__ v, long long i,
                                          const Scalars& s) {
  float pi = p[i], mi = m[i], vi = v[i];
  update(g[i], pi, mi, vi, s);
  p[i] = pi;
  m[i] = mi;
  v[i] = vi;
}

__global__ void __launch_bounds__(kThreads)
adamw_vec_kernel(const float* __restrict__ g, float* __restrict__ p,
                 float* __restrict__ m, float* __restrict__ v, long long n,
                 Scalars s) {
  const long long n4 = n >> 2;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < n4) {
    const float4 gi = reinterpret_cast<const float4*>(g)[i];
    float4 pi = reinterpret_cast<float4*>(p)[i];
    float4 mi = reinterpret_cast<float4*>(m)[i];
    float4 vi = reinterpret_cast<float4*>(v)[i];
    update(gi.x, pi.x, mi.x, vi.x, s);
    update(gi.y, pi.y, mi.y, vi.y, s);
    update(gi.z, pi.z, mi.z, vi.z, s);
    update(gi.w, pi.w, mi.w, vi.w, s);
    reinterpret_cast<float4*>(p)[i] = pi;
    reinterpret_cast<float4*>(m)[i] = mi;
    reinterpret_cast<float4*>(v)[i] = vi;
  } else if (i - n4 < (n & 3)) {              // the last n % 4 elements
    update_at(g, p, m, v, 4 * n4 + (i - n4), s);
  }
}

__global__ void __launch_bounds__(kThreads)
adamw_scalar_kernel(const float* __restrict__ g, float* __restrict__ p,
                    float* __restrict__ m, float* __restrict__ v,
                    long long n, Scalars s) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) update_at(g, p, m, v, i, s);
}

}  // namespace

// One AdamW step of the n float32 elements of p (parameters), m and v
// (moments) in place, from the gradient g, all contiguous.  The scalars are
// float32 values as the plain loop applies them: b1, 1 - b1, b2, 1 - b2, the
// reciprocals of the bias corrections, eps, lr, weight_decay (skipped where
// decay is 0).  Returns a CUDA error code (0: launched, or nothing to do).
extern "C" int repro_adamw(const void* g, void* p, void* m, void* v,
                           long long n, float b1, float one_minus_b1,
                           float b2, float one_minus_b2, float inv_b1c,
                           float inv_b2c, float eps, float lr,
                           float weight_decay, int decay, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const Scalars s{b1, one_minus_b1, b2, one_minus_b2, inv_b1c,
                  inv_b2c, eps, lr, weight_decay, decay != 0};
  const bool vec = ((reinterpret_cast<unsigned long long>(g) |
                     reinterpret_cast<unsigned long long>(p) |
                     reinterpret_cast<unsigned long long>(m) |
                     reinterpret_cast<unsigned long long>(v)) & 15) == 0;
  const long long threads = vec ? (n >> 2) + (n & 3) : n;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    adamw_vec_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const float*>(g), static_cast<float*>(p),
        static_cast<float*>(m), static_cast<float*>(v), n, s);
  else
    adamw_scalar_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const float*>(g), static_cast<float*>(p),
        static_cast<float*>(m), static_cast<float*>(v), n, s);
  return (int)cudaGetLastError();
}
