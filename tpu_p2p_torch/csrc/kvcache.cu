// KV-cache row writes for Hopper (sm_90a): the hand-written port of the
// two Pallas kernels in tpu_p2p/ops/kvcache.py.
//
//   tp_paged_rows_write  replaces _paged_band_kernel (kvcache.py:89):
//     for each slot b with n[b] > 0, copy rows [r0[b], r0[b] + n[b]) of
//     slab8[b] into pool[stage, page[b], :, band[b]*8 + r, :].
//   tp_cache_row_write   replaces _cache_row_kernel (kvcache.py:25):
//     copy slab[b, h, 0, :] into cache[stage, b, h, pos, :].
//
// Bound: pure data movement, so bytes. Each live row is read once from
// the slab and written once into the pool or cache; nothing else moves.
// The TPU kernels read and rewrite a whole 8-row band because a TPU
// block is 8 rows deep; Hopper has no such rule, so these write exactly
// the live rows and never touch a resident row.
//
// Design: one CTA per (slot, KV head). The rows a CTA copies are
// contiguous in both source and destination (consecutive positions of
// one head), so the CTA copies them as one flat run of 16-byte vectors
// when the row size and both base pointers allow it (8, 4 or 2 bytes
// otherwise). The kernels are type-agnostic: they see rows of
// row_bytes bytes, so bf16, f16 and f32 share one code path.
//
// Races: none. Live slots own distinct pages (the copy-on-write
// invariant of the batcher: a page written by a slot has refcount 1),
// and idle slots carry n == 0 and write nothing, so no two CTAs write
// the same byte. Coordinates out of range write nothing (the wrapper
// validates everything it can see without a device sync).
//
// Both entry points run on the caller's stream, in place, allocate
// nothing, and return cudaGetLastError() so the caller can raise on a
// refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V>
__device__ __forceinline__ void copy_run(char* __restrict__ dst,
                                         const char* __restrict__ src,
                                         int64_t bytes) {
  V* d = reinterpret_cast<V*>(dst);
  const V* s = reinterpret_cast<const V*>(src);
  const int64_t vecs = bytes / static_cast<int64_t>(sizeof(V));
  for (int64_t i = threadIdx.x; i < vecs; i += blockDim.x) d[i] = s[i];
}

template <typename V>
__global__ void paged_rows_kernel(char* __restrict__ pool,
                                  const char* __restrict__ slab8,
                                  const int32_t* __restrict__ page,
                                  const int32_t* __restrict__ band,
                                  const int32_t* __restrict__ r0,
                                  const int32_t* __restrict__ n,
                                  int stage, int num_pages, int heads,
                                  int page_len, int row_bytes) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int rows = n[b];
  if (rows <= 0) return;
  const int pg = page[b];
  const int bd = band[b];
  const int r = r0[b];
  if (pg < 0 || pg >= num_pages || bd < 0 || bd * 8 >= page_len || r < 0 ||
      r + rows > 8)
    return;
  const int64_t dst_row =
      ((static_cast<int64_t>(stage) * num_pages + pg) * heads + h) *
          page_len +
      bd * 8 + r;
  const int64_t src_row = (static_cast<int64_t>(b) * heads + h) * 8 + r;
  copy_run<V>(pool + dst_row * row_bytes, slab8 + src_row * row_bytes,
              static_cast<int64_t>(rows) * row_bytes);
}

template <typename V>
__global__ void cache_row_kernel(char* __restrict__ cache,
                                 const char* __restrict__ slab, int stage,
                                 int batch, int heads, int max_len, int pos,
                                 int row_bytes) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int64_t dst_row =
      ((static_cast<int64_t>(stage) * batch + b) * heads + h) * max_len + pos;
  const int64_t src_row = static_cast<int64_t>(b) * heads + h;
  copy_run<V>(cache + dst_row * row_bytes, slab + src_row * row_bytes,
              row_bytes);
}

}  // namespace

extern "C" int tp_paged_rows_write(void* pool, const void* slab8,
                                   const void* page, const void* band,
                                   const void* r0, const void* n, int batch,
                                   int stage, int num_pages, int heads,
                                   int page_len, int row_bytes, int vec,
                                   void* stream) {
  const dim3 grid(batch, heads);
  const int threads = 128;  // 8 rows x 16 vectors of a 256-byte row
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* p = static_cast<char*>(pool);
  const char* s = static_cast<const char*>(slab8);
  const int32_t* pg = static_cast<const int32_t*>(page);
  const int32_t* bd = static_cast<const int32_t*>(band);
  const int32_t* r = static_cast<const int32_t*>(r0);
  const int32_t* nn = static_cast<const int32_t*>(n);
  switch (vec) {
    case 16:
      paged_rows_kernel<uint4><<<grid, threads, 0, st>>>(
          p, s, pg, bd, r, nn, stage, num_pages, heads, page_len, row_bytes);
      break;
    case 8:
      paged_rows_kernel<uint2><<<grid, threads, 0, st>>>(
          p, s, pg, bd, r, nn, stage, num_pages, heads, page_len, row_bytes);
      break;
    case 4:
      paged_rows_kernel<uint32_t><<<grid, threads, 0, st>>>(
          p, s, pg, bd, r, nn, stage, num_pages, heads, page_len, row_bytes);
      break;
    case 2:
      paged_rows_kernel<uint16_t><<<grid, threads, 0, st>>>(
          p, s, pg, bd, r, nn, stage, num_pages, heads, page_len, row_bytes);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tp_cache_row_write(void* cache, const void* slab, int stage,
                                  int batch, int heads, int max_len, int pos,
                                  int row_bytes, int vec, void* stream) {
  const dim3 grid(batch, heads);
  const int threads = 32;  // one row: 16 vectors of a 256-byte row
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* c = static_cast<char*>(cache);
  const char* s = static_cast<const char*>(slab);
  switch (vec) {
    case 16:
      cache_row_kernel<uint4><<<grid, threads, 0, st>>>(
          c, s, stage, batch, heads, max_len, pos, row_bytes);
      break;
    case 8:
      cache_row_kernel<uint2><<<grid, threads, 0, st>>>(
          c, s, stage, batch, heads, max_len, pos, row_bytes);
      break;
    case 4:
      cache_row_kernel<uint32_t><<<grid, threads, 0, st>>>(
          c, s, stage, batch, heads, max_len, pos, row_bytes);
      break;
    case 2:
      cache_row_kernel<uint16_t><<<grid, threads, 0, st>>>(
          c, s, stage, batch, heads, max_len, pos, row_bytes);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
