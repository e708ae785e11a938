// KV-cache row writes for Hopper (sm_90a): one kernel, kv_rows_kernel,
// in place of the two Pallas kernels of tpu_p2p/ops/kvcache.py:
//
//   _cache_row_kernel  (kvcache.py:25): one token row per (slot, KV head)
//     at time pos of the dense cache [S, B, H, T, Dh];
//   _paged_band_kernel (kvcache.py:89): each slot's n <= 8 rows into its
//     page of the pool [S, P, H, L, Dh], inside one 8-row band.
//
// What it computes: for each slot b with n[b] > 0, each KV head h and
// each projection z (K, then V), rows i < n[b] of the source land at
//
//   dst_z[stage, page[b], h, row0[b] + i, :] = src_z[b, h, off[b] + i, :]
//
// with row0 = band*8 + r0 on the pool (page, band, r0 and n are int32
// device vectors) and page = b, row0 = pos, n = 1 on the dense cache
// (scalars: the index pointers are null). off[b] is 0 for rows taken
// from the projections, r0[b] for a band image (a [B, H, 8, Dh] slab
// whose live rows already sit at their in-band rows). The source is
// read in its own layout, [B, H, C, Dh] with any batch, head and row
// strides and a unit stride on Dh, so the projections' einsum output is
// read as it is, permuted or not.
//
// What bounds it: on paper bytes, each live row read once and written
// once (about 0.2 us for both projections at the serving shape). In
// practice the launch floor: a few microseconds of launch and drain for
// any grid, and far more on the host to issue it. The TPU kernels
// rewrite a whole 8-row band because a TPU block is 8 rows deep, and
// the callers built that band image first (four more launches a
// projection). The design answers the floor by launching once where
// there were ten launches: one grid of (slot, KV head, projection)
// covers K and V together, read straight from the projections with no
// band image, and exactly the live rows move. A CTA copies its rows in
// 16-byte vectors, neighbouring threads on neighbouring addresses
// (8, 4 or 2 bytes when the row size, a base pointer or a stride
// requires it); the kernel sees rows of row_bytes bytes, so bf16, f16
// and f32 share one path.
//
// Races: none. Live slots own distinct pages (the batcher's copy-on-
// write invariant: a page written by a slot has refcount 1), idle slots
// carry n == 0 and write nothing, and K and V are distinct tensors, so
// no two CTAs write the same byte. Coordinates out of range write
// nothing (the wrapper validates everything it can see without a
// device sync).
//
// Every entry point runs on the caller's stream, in place, allocates
// nothing, and returns cudaGetLastError() so the caller can raise on a
// refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// One projection's operands: destination base, source base and the
// source's batch, head and row strides in bytes.
struct Proj {
  char* dst;
  const char* src;
  int64_t sb, sh, sr;
};

struct Rows {
  Proj p[2];
  const int32_t* page;  // null: dense cache (page = b, row0 = pos, n = 1)
  const int32_t* band;
  const int32_t* r0;
  const int32_t* n;
  int pos;
  int src_at_r0;  // 1: the source is a band image, its rows start at r0
  int src_rows;   // C, the source's row extent
  int stage, num_pages, heads, page_len, row_bytes;
};

template <typename V>
__global__ void kv_rows_kernel(const Rows a) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  int rows, pg, row0, off;
  if (a.page == nullptr) {
    rows = 1;
    pg = b;
    row0 = a.pos;
    off = 0;
  } else {
    rows = a.n[b];
    if (rows <= 0) return;
    pg = a.page[b];
    const int bd = a.band[b];
    const int r = a.r0[b];
    if (bd < 0 || bd * 8 >= a.page_len || r < 0 || r + rows > 8) return;
    row0 = bd * 8 + r;
    off = a.src_at_r0 ? r : 0;
  }
  if (pg < 0 || pg >= a.num_pages || row0 < 0 || row0 + rows > a.page_len ||
      off + rows > a.src_rows)
    return;
  // A select, not an index: a runtime index into a kernel parameter
  // would copy the parameters to local memory.
  const Proj p = blockIdx.z ? a.p[1] : a.p[0];
  const int64_t dst_row =
      ((static_cast<int64_t>(a.stage) * a.num_pages + pg) * a.heads + h) *
          a.page_len +
      row0;
  V* d = reinterpret_cast<V*>(p.dst + dst_row * a.row_bytes);
  const char* s = p.src + b * p.sb + h * p.sh + off * p.sr;
  const int per_row = a.row_bytes / static_cast<int>(sizeof(V));
  const int total = rows * per_row;
  if (p.sr == a.row_bytes) {
    // Rows contiguous in the source too: one flat run.
    const V* sv = reinterpret_cast<const V*>(s);
    for (int i = threadIdx.x; i < total; i += blockDim.x) d[i] = sv[i];
  } else {
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int r = i / per_row;
      const int c = i - r * per_row;
      d[i] = reinterpret_cast<const V*>(s + r * p.sr)[c];
    }
  }
}

__global__ void empty_kernel() {}

int launch(const Rows& a, int batch, int nproj, int threads, int vec,
           void* stream) {
  if (nproj < 1 || nproj > 2) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(batch, a.heads, nproj);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 16:
      kv_rows_kernel<uint4><<<grid, threads, 0, st>>>(a);
      break;
    case 8:
      kv_rows_kernel<uint2><<<grid, threads, 0, st>>>(a);
      break;
    case 4:
      kv_rows_kernel<uint32_t><<<grid, threads, 0, st>>>(a);
      break;
    case 2:
      kv_rows_kernel<uint16_t><<<grid, threads, 0, st>>>(a);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Rows into the paged pool. nproj = 2 writes K (dst0/src0) and V
// (dst1/src1) in one launch; nproj = 1 writes dst0 from src0 only.
// Strides are in bytes; src_at_r0 = 1 reads a band image.
extern "C" int tp_kv_rows_paged(
    void* dst0, const void* src0, int64_t sb0, int64_t sh0, int64_t sr0,
    void* dst1, const void* src1, int64_t sb1, int64_t sh1, int64_t sr1,
    const void* page, const void* band, const void* r0, const void* n,
    int nproj, int src_at_r0, int src_rows, int batch, int stage,
    int num_pages, int heads, int page_len, int row_bytes, int vec,
    int threads, void* stream) {
  Rows a;
  a.p[0] = Proj{static_cast<char*>(dst0), static_cast<const char*>(src0),
                sb0, sh0, sr0};
  a.p[1] = Proj{static_cast<char*>(dst1), static_cast<const char*>(src1),
                sb1, sh1, sr1};
  a.page = static_cast<const int32_t*>(page);
  a.band = static_cast<const int32_t*>(band);
  a.r0 = static_cast<const int32_t*>(r0);
  a.n = static_cast<const int32_t*>(n);
  if (a.page == nullptr || a.band == nullptr || a.r0 == nullptr ||
      a.n == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  a.pos = 0;
  a.src_at_r0 = src_at_r0;
  a.src_rows = src_rows;
  a.stage = stage;
  a.num_pages = num_pages;
  a.heads = heads;
  a.page_len = page_len;
  a.row_bytes = row_bytes;
  return launch(a, batch, nproj, threads, vec, stream);
}

// One row per (slot, head) into the dense cache [S, B, H, T, Dh] at
// time pos: the pool form with page = b, row0 = pos, n = 1.
extern "C" int tp_kv_rows_dense(
    void* dst0, const void* src0, int64_t sb0, int64_t sh0,
    void* dst1, const void* src1, int64_t sb1, int64_t sh1,
    int nproj, int pos, int batch, int stage, int heads, int max_len,
    int row_bytes, int vec, int threads, void* stream) {
  Rows a;
  a.p[0] = Proj{static_cast<char*>(dst0), static_cast<const char*>(src0),
                sb0, sh0, row_bytes};
  a.p[1] = Proj{static_cast<char*>(dst1), static_cast<const char*>(src1),
                sb1, sh1, row_bytes};
  a.page = a.band = a.r0 = a.n = nullptr;
  a.pos = pos;
  a.src_at_r0 = 0;
  a.src_rows = 1;
  a.stage = stage;
  a.num_pages = batch;
  a.heads = heads;
  a.page_len = max_len;
  a.row_bytes = row_bytes;
  return launch(a, batch, nproj, threads, vec, stream);
}

// An empty kernel over the same grid and block: the launch floor that
// chip_smoke.py times beside the writes.
extern "C" int tp_kv_empty(int batch, int heads, int nproj, int threads,
                           void* stream) {
  empty_kernel<<<dim3(batch, heads, nproj), threads, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
