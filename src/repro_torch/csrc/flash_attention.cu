// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention_pallas` (_flash_kernel) of
// src/repro/kernels/flash_attention/flash_attention.py.  There, a
// (B*H, Tq/bq, Tk/bk) grid walked the kv axis sequentially ("arbitrary"),
// keeping the online-softmax state m, l, acc in VMEM scratch across grid
// steps, with the head dim padded to 128 lanes and T % 128 == 0 asserted.
//
// What bounds it here: operations.  One call does 4*B*H*Tq*Tk_live*hd flops
// on (B*H + 2*B*Hkv)*T*hd inputs, i.e. hundreds of flops per byte at the
// main path's T = 1024, far above the card's ridge.  This first kernel runs
// them as fp32 FMAs (67 TFLOP/s peak), not on the tensor cores; wgmma/TMA
// are later work.
//
// What the design does about that:
//  * Hopper blocks run in no order, so nothing carries across blocks: one
//    block owns one (batch*head, 64-row query tile) and loops over the
//    64-row kv tiles itself, holding m, l and the output accumulator in
//    registers (fp32), the tiles in shared memory (fp32, rows padded by one
//    word against bank conflicts).
//  * 256 threads as 16 x 16: thread (ty, tx) owns rows ty + 16i and score
//    columns tx + 16j (a 4 x 4 micro-tile) and output columns tx + 16c;
//    row max / row sum reduce over the 16 lanes of a half-warp by shuffles.
//  * Dead kv tiles are skipped exactly as the TPU kernel skips them
//    (causal: k_lo > q_lo + 63; window: k_hi - 1 <= q_lo - window).
//  * Masked logits are -1e30 (not -inf), scale is applied before the
//    softcap, as in the TPU kernel.  A ragged T tail is masked (rows past
//    T are neither loaded nor written), so T need not divide 64.
//  * GQA reads kv head h / n_rep; nothing is repeated in memory.  The head
//    dim is taken as it is (template width 64 / 128 / 256, masked), not
//    padded in memory.  Inputs are read through (batch, head, time)
//    strides, so the model's (B, T, H, hd) layout needs no transpose.
//  * f32 and bf16 inputs; bf16 is widened to fp32 on load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, h, t;
};

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

template <int HD>
constexpr int smem_floats() {
  return BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H,
                 int n_rep, int Tq, int Tk, int hd, Strides sq, Strides sk,
                 Strides sv, Strides so, float scale, float softcap,
                 int causal, int window) {
  constexpr int QP = HD + 1;   // padded row of Qs / Ks
  constexpr int PP = BK + 1;   // padded row of Ps
  constexpr int R = BQ / 16;   // rows per thread
  constexpr int C = BK / 16;   // score columns per thread
  constexpr int DC = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * QP;
  float* Vs = Ks + BK * QP;
  float* Ps = Vs + BK * HD;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / n_rep;
  const int q_lo = blockIdx.x * BQ;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;
  T* ob = o + b * so.b + h * so.h;

  for (int i = threadIdx.x; i < BQ * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd, t = q_lo + r;
    Qs[r * QP + d] = t < Tq ? to_f(qb[t * sq.t + d]) : 0.f;
  }

  float m[R], l[R], acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int n_kv = (Tk + BK - 1) / BK;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k_lo = kt * BK;
    if (causal && k_lo > q_lo + BQ - 1) break;              // future tiles
    if (window > 0 && k_lo + BK - 1 <= q_lo - window) continue;  // too old
    __syncthreads();  // previous tile's Ks / Vs / Ps reads are done
    for (int i = threadIdx.x; i < BK * hd; i += kThreads) {
      const int r = i / hd, d = i - r * hd, t = k_lo + r;
      const bool in = t < Tk;
      Ks[r * QP + d] = in ? to_f(kb[t * sk.t + d]) : 0.f;
      Vs[r * HD + d] = in ? to_f(vb[t * sv.t + d]) : 0.f;
    }
    __syncthreads();

    float s[R][C];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      float qv[R], kv[C];
#pragma unroll
      for (int i = 0; i < R; ++i) qv[i] = Qs[(ty + 16 * i) * QP + d];
#pragma unroll
      for (int j = 0; j < C; ++j) kv[j] = Ks[(tx + 16 * j) * QP + d];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qp = q_lo + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int kp = k_lo + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool ok = kp < Tk;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        s[i][j] = ok ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * PP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[R], vv[DC];
#pragma unroll
      for (int i = 0; i < R; ++i) pv[i] = Ps[(ty + 16 * i) * PP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = Vs[kk * HD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int t = q_lo + ty + 16 * i;
    if (t >= Tq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) ob[t * so.t + d] = from_f<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Hkv, int Tq, int Tk, int hd, const long long* st, float scale,
           float softcap, int causal, int window, cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  dim3 grid((Tq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, H / Hkv, Tq, Tk, hd,
      sq, sk, sv, so, scale, softcap, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o, int B,
                int H, int Hkv, int Tq, int Tk, int hd, const long long* st,
                float scale, float softcap, int causal, int window,
                cudaStream_t s) {
  if (hd <= 64)
    return launch<T, 64>(q, k, v, o, B, H, Hkv, Tq, Tk, hd, st, scale, softcap,
                         causal, window, s);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, o, B, H, Hkv, Tq, Tk, hd, st, scale,
                          softcap, causal, window, s);
  if (hd <= 256)
    return launch<T, 256>(q, k, v, o, B, H, Hkv, Tq, Tk, hd, st, scale,
                          softcap, causal, window, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int is_bf16, int B,
    int H, int Hkv, int Tq, int Tk, int hd, const long long* strides,
    float scale, float softcap, int causal, int window, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Tq <= 0 || Tk <= 0 ||
      hd <= 0 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_hd<__nv_bfloat16>(q, k, v, o, B, H, Hkv, Tq, Tk, hd,
                                      strides, scale, softcap, causal, window,
                                      s);
  return dispatch_hd<float>(q, k, v, o, B, H, Hkv, Tq, Tk, hd, strides, scale,
                            softcap, causal, window, s);
}
