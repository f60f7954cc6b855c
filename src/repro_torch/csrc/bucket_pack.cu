// Bucket pack / unpack for Hopper (sm_90a): a balanced ragged copy.
//
// Replaces the TPU kernels `pack_pallas` (_pack_kernel, index map
// _pack_index_out) and `unpack_pallas` (_unpack_masked_kernel) of
// src/repro/kernels/bucket_pack/bucket_pack.py.  There, a (K, Lmax // TILE)
// grid copied one 512-element tile per program through VMEM, and tiles past a
// segment's aligned length were redirected to a scratch tile (pack) or zeroed
// (unpack).
//
// What bounds it here: nothing but device-memory bytes.  Each piece is read
// once and written once, so the least time is (bytes read + bytes written)
// over 3.35 TB/s; there is no arithmetic at all.
//
// What the design does about that:
//  * Work split by bytes, not by piece.  The wrapper (ops.py::split_work)
//    hands the kernel a table of the pieces in order: begin offset in the
//    pieces' concatenated byte range, source address (0 = write zeros),
//    destination address, bytes.  Block c copies bytes [16 KB c, 16 KB
//    (c + 1)) of that range, finding its first piece by bisection, so every
//    block has the same work whatever the pieces' sizes, and the blocks in
//    flight at any moment cover one compact window of each buffer.  (A few
//    blocks an SM, each walking one long run of its own, lost to torch.cat
//    on the card: hundreds of concurrent streams against DRAM.)
//  * No stream sync.  The table reaches the card by an asynchronous copy
//    from pinned host memory, ahead of the launch on the same stream.
//  * Streaming body.  Where source and destination share their offset
//    modulo 16, each thread issues four 16-byte loads before their stores,
//    with streaming cache hints (__ldcs / __stcs: the data is touched once),
//    after peeling the unaligned head and before the tail.  Else 4 bytes at
//    a time where both are 4-byte aligned, else single bytes.  Copying bytes
//    keeps the kernel exact for any element type (f32, bf16): the result is
//    bitwise the plain version's.
//
// The same kernel serves pack (many sources, one destination buffer) and
// unpack (one source, many destinations, zero-filled row ends); the Python
// wrappers keep one launch count for each.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr long long kChunk = 16LL * kThreads * kUnroll;  // one body step

__device__ __forceinline__ void copy_bytes(const uint8_t* __restrict__ src,
                                           uint8_t* __restrict__ dst,
                                           long long n) {
  for (long long i = threadIdx.x; i < n; i += kThreads)
    dst[i] = src ? src[i] : 0;
}

__device__ __forceinline__ void copy_vec16(const uint4* __restrict__ src,
                                           uint4* __restrict__ dst,
                                           long long n) {
  long long i = threadIdx.x;
  if (src) {
    for (; i + (kUnroll - 1) * kThreads < n; i += kUnroll * kThreads) {
      uint4 x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) x[u] = __ldcs(src + i + u * kThreads);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) __stcs(dst + i + u * kThreads, x[u]);
    }
    for (; i < n; i += kThreads) __stcs(dst + i, __ldcs(src + i));
  } else {
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (; i < n; i += kThreads) __stcs(dst + i, z);
  }
}

__device__ __forceinline__ void copy_row(const uint8_t* __restrict__ src,
                                         uint8_t* __restrict__ dst,
                                         long long n) {
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  long long head = (long long)((16 - (d & 15)) & 15);
  if (head > n) head = n;
  if (src == nullptr || ((s + head) & 15) == 0) {
    // 16-byte body: head bytes, aligned uint4 body, tail bytes
    copy_bytes(src, dst, head);
    const long long nvec = (n - head) >> 4;
    copy_vec16(src ? reinterpret_cast<const uint4*>(src + head) : nullptr,
               reinterpret_cast<uint4*>(dst + head), nvec);
    const long long done = head + (nvec << 4);
    copy_bytes(src ? src + done : nullptr, dst + done, n - done);
  } else if (((s | d) & 3) == 0) {
    // both 4-byte aligned (f32 shards at arbitrary element offsets)
    const long long nw = n >> 2;
    const uint32_t* sw = reinterpret_cast<const uint32_t*>(src);
    uint32_t* dw = reinterpret_cast<uint32_t*>(dst);
    for (long long i = threadIdx.x; i < nw; i += kThreads)
      __stcs(dw + i, __ldcs(sw + i));
    copy_bytes(src + (nw << 2), dst + (nw << 2), n - (nw << 2));
  } else {
    copy_bytes(src, dst, n);
  }
}

// table: for each piece in range order (begin offset in the concatenated
// byte range, src address or 0, dst address, bytes), all bytes > 0.
// Block c copies bytes [c * kChunk, (c + 1) * kChunk) of the range.
__global__ void __launch_bounds__(kThreads)
copy_chunks_kernel(const long long* __restrict__ table, int n_pieces,
                   long long total) {
  const long long lo = (long long)blockIdx.x * kChunk;
  const long long hi = lo + kChunk < total ? lo + kChunk : total;
  int p = 0;  // the last piece that begins at or before lo, by bisection
  for (int top = n_pieces - 1; p < top;) {
    const int mid = (p + top + 1) / 2;
    if (__ldg(table + 4 * mid) <= lo) p = mid;
    else top = mid - 1;
  }
  for (; p < n_pieces; ++p) {
    const long long* row = table + 4 * p;
    const long long begin = __ldg(row), end = begin + __ldg(row + 3);
    if (begin >= hi) break;
    const long long a = begin > lo ? begin : lo, off = a - begin;
    const long long src = __ldg(row + 1);
    copy_row(reinterpret_cast<const uint8_t*>(src ? src + off : 0),
             reinterpret_cast<uint8_t*>(__ldg(row + 2) + off),
             (end < hi ? end : hi) - a);
  }
}

}  // namespace

// table: device int64 (n_pieces, 4) = (begin, src address or 0, dst address,
// bytes) in range order, total = the bytes of all pieces; one block a chunk
extern "C" int repro_copy_pieces(const void* table, int n_pieces,
                                 long long total, void* stream) {
  if (n_pieces <= 0 || total <= 0) return 0;
  const long long n_blocks = (total + kChunk - 1) / kChunk;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  copy_chunks_kernel<<<(unsigned)n_blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(
      static_cast<const long long*>(table), n_pieces, total);
  return (int)cudaGetLastError();
}
