// Bucket pack / unpack for Hopper (sm_90a): a ragged segment copy.
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
// What the design does about that: the copy is not done tile by tile.  The
// wrapper builds a small table of pieces in device memory, one row of three
// 64-bit words per piece: source address (0 = write zeros), destination
// address, length in bytes.  Block (x, y) serves piece y and strides over it
// with the gridDim.x blocks of that piece, so one long piece (a 243 MB layer)
// is spread over the whole card and short ones cost a few idle blocks.
// Where source and destination share their offset modulo 16 the body moves
// 16 bytes per thread per step (peeling the unaligned head and tail), else
// 4 bytes, else single bytes.  Copying bytes makes the kernel exact for any
// element type (f32, bf16): the result is bitwise the plain version's.
//
// The same kernel serves pack (many sources, one destination buffer) and
// unpack (one source, many destinations, zero-filled row ends); the Python
// wrappers keep one launch count for each.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void copy_bytes(const uint8_t* src, uint8_t* dst,
                                           long long n, long long tid,
                                           long long stride) {
  for (long long i = tid; i < n; i += stride) dst[i] = src ? src[i] : 0;
}

__global__ void __launch_bounds__(kThreads)
copy_pieces_kernel(const long long* __restrict__ table) {
  const long long* row = table + 3 * (long long)blockIdx.y;
  const uint8_t* src = reinterpret_cast<const uint8_t*>(row[0]);
  uint8_t* dst = reinterpret_cast<uint8_t*>(row[1]);
  const long long n = row[2];
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;

  const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  long long head = (long long)((16 - (d & 15)) & 15);
  if (head > n) head = n;
  if (src == nullptr || ((s + head) & 15) == 0) {
    // 16-byte body: head bytes, aligned uint4 body, tail bytes
    copy_bytes(src, dst, head, tid, stride);
    const long long nvec = (n - head) >> 4;
    uint4* dv = reinterpret_cast<uint4*>(dst + head);
    if (src) {
      const uint4* sv = reinterpret_cast<const uint4*>(src + head);
      for (long long i = tid; i < nvec; i += stride) dv[i] = sv[i];
    } else {
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      for (long long i = tid; i < nvec; i += stride) dv[i] = z;
    }
    const long long done = head + (nvec << 4);
    copy_bytes(src ? src + done : nullptr, dst + done, n - done, tid, stride);
  } else if (((s | d) & 3) == 0) {
    // both 4-byte aligned (f32 shards at arbitrary element offsets)
    const long long nw = n >> 2;
    const uint32_t* sw = reinterpret_cast<const uint32_t*>(src);
    uint32_t* dw = reinterpret_cast<uint32_t*>(dst);
    for (long long i = tid; i < nw; i += stride) dw[i] = sw[i];
    copy_bytes(src + (nw << 2), dst + (nw << 2), n - (nw << 2), tid, stride);
  } else {
    copy_bytes(src, dst, n, tid, stride);
  }
}

}  // namespace

// table: device int64 (n_pieces, 3) = (src address or 0, dst address, bytes)
extern "C" int repro_copy_pieces(const void* table, int n_pieces,
                                 int blocks_per_piece, void* stream) {
  if (n_pieces <= 0) return 0;
  dim3 grid(blocks_per_piece, n_pieces);
  copy_pieces_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const long long*>(table));
  return (int)cudaGetLastError();
}
