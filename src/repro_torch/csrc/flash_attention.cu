// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention_pallas` (_flash_kernel) of
// src/repro/kernels/flash_attention/flash_attention.py.  There, a
// (B*H, Tq/bq, Tk/bk) grid walked the kv axis sequentially ("arbitrary"),
// keeping the online-softmax state m, l, acc in VMEM scratch across grid
// steps, with the head dim padded to 128 lanes and T % 128 == 0 asserted.
//
// What bounds it here: fp32 operations.  One call does 4*B*H*Tq*Tk_live*hd
// flops on (B*H + 2*B*Hkv)*T*hd inputs, hundreds of flops per byte at the
// paths' T = 1024, far above the card's ridge.  The arithmetic stays fp32 on
// the CUDA cores (67 TFLOP/s): 3xTF32 on the tensor cores misses the f32
// tolerance (PERF.md section 7).  An SM issues 128 FMAs a clock but reads
// only 32 words of shared memory a clock, so a kernel that reads an operand
// word for every FMA or two is held to half the peak or less by shared
// memory before anything else.
//
// What the design does about that:
//  * Register blocking.  Each thread owns an 8 x 8 micro-tile of the output
//    O and an MR x MC micro-tile of the score tile S = Q K^T: 8 x 8 at head
//    dim 64, 8 x 4 at 128, 4 x 4 at 256.  Operands are read as float4: in P V
//    and at hd 64 in Q K^T, 16 vector loads feed 256 FMAs (4 FMAs a word).
//    Each score is summed over the head dim in order by one thread, as the
//    plain version's GEMM sums it: a depth split over lanes, which would
//    allow 8 x 8 at every width, moved the f32 error at hd 256 past 2e-6.
//    Q and K sit in shared memory row-major, rows padded by 4 words, so that
//    the float4 reads of one quarter-warp hit distinct banks; the lanes that
//    share a row read one address.
//  * Pipelined K/V.  Tiles arrive by cp.async (16 bytes, zero-filled past T
//    and past hd) into one K and one V buffer: the next K tile loads while
//    the softmax and P V run, the next V tile while the next Q K^T runs.
//    The Q tile loads once per block and stays in shared memory.
//  * The softmax.  Row max and row sum reduce over the lanes of a row by
//    shuffles; P goes to shared memory once per tile (one store a score),
//    the rescale factor of each row beside it.
//  * Tiles per width, BK = 64 keys: hd 64 runs 128-query blocks of 128
//    threads (102 KB, two blocks an SM); hd 128 64-query blocks of 128
//    (115 KB); hd 256 64-query blocks of 256 (211 KB, one an SM).  Blocks
//    start with the longest causal rows first.
//  * Latent attention (MLA) reads q and k of 192 (128 without positions,
//    64 with rope) and v of 128: a template of its own computes Q K^T over
//    192 columns and P V and O over 128 (HD = 192, HDV = 128; 64-query
//    blocks of 128 threads, the S micro-tile of hd 128's, 147 KB).  Every
//    other instance has HDV = HD.
//  * Kept from the first kernel: one block per (batch*head, query tile), m,
//    l and the output in registers; dead kv tiles skipped as the TPU kernel
//    skips them (causal: k_lo > q_hi; window: k_hi - 1 <= q_lo - window);
//    masked logits -1e30, the scale before the softcap, fmaxf(l, 1e-30);
//    GQA by kv-head index; any T and any hd up to 256, masked inside the
//    template width; (batch, head, time) strides, so the model's
//    (B, T, H, hd) layout needs no transpose.  bf16 is widened to fp32 as it
//    is stored to shared memory (by plain loads: cp.async cannot convert);
//    so are f32 inputs whose rows are not 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>
#include <type_traits>

namespace {

constexpr int BK = 64;
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

// The tiles of one head-dim template: q and k of HD, v and o of HDV, BQ
// queries a block, an MR x MC micro-tile of S and an 8 x 8 micro-tile of O
// a thread.
template <int HD_, int HDV_, int BQ_, int MR_, int MC_>
struct Cfg {
  static constexpr int HD = HD_, HDV = HDV_, BQ = BQ_, MR = MR_, MC = MC_;
  static constexpr int TY = BQ / 8;          // O rows of a thread: ro + TY*i
  static constexpr int NT = TY * (HDV / 8);  // threads: one O micro-tile each
  static constexpr int SY = BQ / MR;        // S rows of a thread: ty + SY*i
  static constexpr int SX = BK / MC;        // S columns: tx + SX*j
  static constexpr int QS = HD + 4;         // row stride of Qs / Ks (floats)
  static constexpr int PS = BK + 4;         // row stride of Ps
  static constexpr int SMEM_FLOATS =
      BQ * QS + BK * QS + BK * HDV + BQ * PS + BQ;
  static_assert(SY * SX == NT, "S and O micro-tiles must match");
  static_assert(SX >= 8 && SX <= 32, "a row's lanes: 8 to 32 of one warp");
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Rows [t0, t0 + ROWS) of a (T, hd) slab with time stride st into shared
// rows of SS floats, HD of them filled: zeros past T and past hd.
template <typename T, int ROWS, int HD, int SS, int NT>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long st, int t0, int t_end,
                                          int hd, int vec) {
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {  // 16-byte rows: cp.async, in flight until waited for
      constexpr int C4 = HD / 4;
      for (int i = threadIdx.x; i < ROWS * C4; i += NT) {
        const int r = i / C4, c = (i % C4) * 4, t = t0 + r;
        const bool in = t < t_end && c < hd;
        cp_async16(dst + r * SS + c, in ? src + t * st + c : src, in);
      }
      return;
    }
  }
  for (int i = threadIdx.x; i < ROWS * HD; i += NT) {
    const int r = i / HD, d = i % HD, t = t0 + r;
    dst[r * SS + d] = (t < t_end && d < hd) ? to_f(src[t * st + d]) : 0.f;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float comp(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

template <typename T, int HD, int HDV, int BQ, int MR, int MC>
__global__ void __launch_bounds__(Cfg<HD, HDV, BQ, MR, MC>::NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H,
                 int n_rep, int Tq, int Tk, int hd, int hdv, Strides sq,
                 Strides sk, Strides sv, Strides so, float scale,
                 float softcap, int causal, int window, int vec) {
  using C = Cfg<HD, HDV, BQ, MR, MC>;
  constexpr int TY = C::TY, SY = C::SY, SX = C::SX, QS = C::QS, PS = C::PS,
                NT = C::NT;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * QS;
  float* Vs = Ks + BK * QS;
  float* Ps = Vs + BK * HDV;
  float* Rs = Ps + BQ * PS;  // per row: the tile's rescale, at the end l

  const int tid = threadIdx.x;
  // S layout: tx (columns tx + SX*j) in the low lane bits, ty (rows)
  const int tx = tid % SX, ty = tid / SX;
  // O layout: rows ro + TY*i, columns 4co.. 4co + 3 and HDV/2 + 4co..
  const int co = tid % (HDV / 8), ro = tid / (HDV / 8);
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / n_rep;
  const int q_lo = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest rows first
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;
  T* ob = o + b * so.b + h * so.h;

  int kt_lo = 0, kt_hi = (Tk + BK - 1) / BK;
  if (causal) kt_hi = min(kt_hi, (q_lo + BQ - 1) / BK + 1);  // future tiles
  if (window > 0 && q_lo - window + 1 > 0)                   // too old
    kt_lo = (q_lo - window + 1) / BK;

  float acc[8][8], m[MR], l[MR];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }

  if (kt_lo < kt_hi) {
    load_tile<T, BQ, HD, QS, NT>(Qs, qb, sq.t, q_lo, Tq, hd, vec);
    load_tile<T, BK, HD, QS, NT>(Ks, kb, sk.t, kt_lo * BK, Tk, hd, vec);
    cp_async_commit();
    load_tile<T, BK, HDV, HDV, NT>(Vs, vb, sv.t, kt_lo * BK, Tk, hdv, vec);
    cp_async_commit();
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k_lo = kt * BK;
    cp_async_wait_all_but_one();  // this tile's K (and Q) have landed
    __syncthreads();

    float s[MR][MC];
#pragma unroll
    for (int i = 0; i < MR; ++i)
#pragma unroll
      for (int j = 0; j < MC; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      float4 qv[MR], kv[MC];
#pragma unroll
      for (int i = 0; i < MR; ++i) qv[i] = ld4(Qs + (ty + SY * i) * QS + d);
#pragma unroll
      for (int j = 0; j < MC; ++j) kv[j] = ld4(Ks + (tx + SX * j) * QS + d);
#pragma unroll
      for (int i = 0; i < MR; ++i)
#pragma unroll
        for (int j = 0; j < MC; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }
    __syncthreads();  // every thread is done with Ks
    if (kt + 1 < kt_hi)
      load_tile<T, BK, HD, QS, NT>(Ks, kb, sk.t, k_lo + BK, Tk, hd, vec);
    cp_async_commit();

#pragma unroll
    for (int r = 0; r < MR; ++r) {
      const int row = ty + SY * r;
      const int qp = q_lo + row;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < MC; ++j) {
        const int kp = k_lo + tx + SX * j;
        float x = s[r][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool ok = kp < Tk;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        s[r][j] = ok ? x : kNegInf;
        mx = fmaxf(mx, s[r][j]);
      }
#pragma unroll
      for (int off = 1; off < SX; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < MC; ++j) {
        const float p = expf(s[r][j] - m_new);
        Ps[row * PS + tx + SX * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 1; off < SX; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
      if (tx == 0) Rs[row] = alpha;
    }
    cp_async_wait_all_but_one();  // this tile's V has landed
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float alpha = Rs[ro + TY * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) pv[i] = ld4(Ps + (ro + TY * i) * PS + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float4 vv[2];
#pragma unroll
        for (int c = 0; c < 2; ++c)
          vv[c] = ld4(Vs + (kk + u) * HDV + c * (HDV / 2) + 4 * co);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float p = comp(pv[i], u);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            acc[i][4 * c] = fmaf(p, vv[c].x, acc[i][4 * c]);
            acc[i][4 * c + 1] = fmaf(p, vv[c].y, acc[i][4 * c + 1]);
            acc[i][4 * c + 2] = fmaf(p, vv[c].z, acc[i][4 * c + 2]);
            acc[i][4 * c + 3] = fmaf(p, vv[c].w, acc[i][4 * c + 3]);
          }
        }
      }
    }
    __syncthreads();  // every thread is done with Vs, Ps and Rs
    if (kt + 1 < kt_hi)
      load_tile<T, BK, HDV, HDV, NT>(Vs, vb, sv.t, k_lo + BK, Tk, hdv, vec);
    cp_async_commit();
  }

#pragma unroll
  for (int r = 0; r < MR; ++r)
    if (tx == 0) Rs[ty + SY * r] = l[r];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = ro + TY * i, t = q_lo + row;
    if (t >= Tq) continue;
    const float denom = fmaxf(Rs[row], 1e-30f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = (j / 4) * (HDV / 2) + 4 * co + j % 4;
      if (d < hdv) ob[t * so.t + d] = from_f<T>(acc[i][j] / denom);
    }
  }
}

template <typename T, int HD, int HDV, int BQ, int MR, int MC>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Hkv, int Tq, int Tk, int hd, int hdv, const long long* st,
           float scale, float softcap, int causal, int window,
           cudaStream_t stream) {
  using C = Cfg<HD, HDV, BQ, MR, MC>;
  constexpr int bytes = C::SMEM_FLOATS * (int)sizeof(float);
  const int n_q = (Tq + BQ - 1) / BQ;
  if (n_q > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD, HDV, BQ, MR, MC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  // cp.async moves 16 aligned bytes: f32 rows of 4-float multiples only
  bool vec = std::is_same<T, float>::value && hd % 4 == 0 && hdv % 4 == 0 &&
             (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
              reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  for (int i = 0; i < 9; ++i) vec = vec && st[i] % 4 == 0;
  dim3 grid(B * H, n_q);
  flash_fwd_kernel<T, HD, HDV, BQ, MR, MC><<<grid, C::NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, H / Hkv, Tq, Tk, hd,
      hdv, sq, sk, sv, so, scale, softcap, causal, window, (int)vec);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o, int B,
                int H, int Hkv, int Tq, int Tk, int hd, int hdv,
                const long long* st, float scale, float softcap, int causal,
                int window, cudaStream_t s) {
  if (hdv != hd) {  // a narrower v: the latent-attention template
    if (hd <= 192 && hdv <= 128)
      return launch<T, 192, 128, 64, 8, 4>(q, k, v, o, B, H, Hkv, Tq, Tk, hd,
                                           hdv, st, scale, softcap, causal,
                                           window, s);
    return (int)cudaErrorInvalidValue;
  }
  if (hd <= 64)
    return launch<T, 64, 64, 128, 8, 8>(q, k, v, o, B, H, Hkv, Tq, Tk, hd, hd,
                                        st, scale, softcap, causal, window, s);
  if (hd <= 128)
    return launch<T, 128, 128, 64, 8, 4>(q, k, v, o, B, H, Hkv, Tq, Tk, hd, hd,
                                         st, scale, softcap, causal, window, s);
  if (hd <= 256)
    return launch<T, 256, 256, 64, 4, 4>(q, k, v, o, B, H, Hkv, Tq, Tk, hd, hd,
                                         st, scale, softcap, causal, window, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int is_bf16, int B,
    int H, int Hkv, int Tq, int Tk, int hd, int hdv,
    const long long* strides, float scale, float softcap, int causal,
    int window, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Tq <= 0 || Tk <= 0 ||
      hd <= 0 || hdv <= 0 || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_hd<__nv_bfloat16>(q, k, v, o, B, H, Hkv, Tq, Tk, hd, hdv,
                                      strides, scale, softcap, causal, window,
                                      s);
  return dispatch_hd<float>(q, k, v, o, B, H, Hkv, Tq, Tk, hd, hdv, strides,
                            scale, softcap, causal, window, s);
}
