// Flash attention for Hopper (sm_90a): the hand-written port of the five
// Pallas flash kernels in tpu_p2p/ops/flash_attention.py.
//
//   tp_flash_fwd (float32) and tp_flash_fwd_wgmma (bfloat16) replace
//     _kernel (:101, the rectangular/banded sweep) and _kernel_flat
//     (:208, the live-cell causal sweep): one online-softmax accumulate
//     of q tiles over KV tiles against an (o, m, l) carry, with global
//     offsets, causal, sliding window and GQA (the narrow KV row of
//     _kv_row_map :339).
//   tp_flash_bwd_dkdv (float32) and tp_flash_bwd_dkdv_wgmma (bfloat16)
//     replace _bwd_dkdv_kernel (:717) and the GQA group sum after it
//     (_flash_bwd :1310-1314): dK, dV from the saved logsumexp, written
//     straight into the narrow [B*Hkv, Tk, D] rows.
//   tp_flash_bwd_dq (float32) and tp_flash_bwd_dq_wgmma (bfloat16)
//     replace _bwd_dq_kernel (:826) and, for the fused causal form,
//     _dq_reduce_kernel (:693) with its partial-dq slabs.
//
// What bounds them: at the training shape (T 4096, D 128) the work is
// O(T^2 D) multiply-adds over O(T D) bytes, so operations, not bytes.
// Two families:
//   - SIMT (flash_fwd_kernel, flash_bwd_dkdv_kernel, flash_bwd_dq_kernel;
//     float32 only): float32 FMAs over shared-memory tiles, so their
//     ceiling is the card's float32 rate. Float32 stays here: tensor
//     cores would mean TF32.
//   - Tensor cores (flash_fwd_kernel_wgmma, flash_bwd_dkdv_kernel_wgmma,
//     flash_bwd_dq_kernel_wgmma; bfloat16 only): bf16 tiles in swizzled
//     shared memory, filled by a cp.async ring, products on wgmma
//     (section "bf16 on the tensor cores" below; building blocks in
//     sm90.cuh), so their ceiling is the bf16 tensor-core rate.

// Design. Pallas carries the (o, m, l) and dK/dV/dQ accumulators across a
// sequential grid and revisits output blocks; Hopper runs blocks in
// parallel with nothing carried between them, so the innermost grid
// dimension becomes a loop inside one CTA that keeps its accumulators in
// registers:
//   - fwd and dq: one CTA per (B*Hq row, q tile), looping over the
//     live KV tiles only: causal ends the loop at the diagonal tile (all
//     that the flat live-cell grid bought on the TPU), a window starts it
//     at the band's first tile (what the banded index map bought). Heavy
//     q tiles (late in a causal sweep) are launched first.
//   - dkdv: one CTA per (B*Hkv row, k tile), looping over the
//     group's query heads and their live q tiles; a k tile with no live
//     q tile writes zeros.
//   - dq is its own pass (FlashAttention-2): no atomics, so dq is the
//     same from run to run; the TPU's partial-dq slabs and their reduce
//     existed only because its grid cannot sum across cells.
// Tiles that are entirely visible skip the mask (_tile_liveness :82).
//
// Math, shared with the plain versions in ops/flash_attention.py: q is
// multiplied by fold = log2(e)/sqrt(D) and rounded back to its dtype on
// load; every exponential is exp2; m crosses the boundary in natural log.
// Forward: masked scores are -inf, so they never move the running max
// (a fully-masked row keeps its carry and l stays 0). Backward: masked
// scores are NEG_INF = -1e30 and P = exp2(S - L*log2e) underflows to an
// exact 0, also for rows with L = +1e30. p is rounded to v's dtype before
// P.V and dV; ds to q's (k's) dtype before dK (dQ).
//
// SIMT layout: 256 threads as a 16 x 16 grid (ty, tx). A thread owns rows
// ty + 16 i (i < 4) of every 64-row tile and columns tx + 16 j of every
// 64-column score tile or D-wide accumulator, so a row's 16 owners sit in
// one half-warp and reduce with xor-shuffles. Tiles sit in shared memory
// as float with a row stride of D + 1 (no bank conflicts on the column
// walks). Rows past Tq or Tk load as zeros; keys past Tk are masked. The
// SIMT kernels stay templates on the element type but are built for
// float32 only (dispatch).
//
// Every entry point runs on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int BQ = 64;   // q rows per tile
constexpr int BK = 64;   // k rows per tile
constexpr int NT = 256;  // threads per CTA
constexpr int PLD = BK + 1;
constexpr float LOG2E_F = 1.4426950408889634f;
constexpr float LN2_F = 0.6931471805599453f;
constexpr float NEG_INF_F = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }

// x rounded to T and widened back: the reference's .astype(T) on an f32
// (float32 only: no bf16 SIMT kernel is built).
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Rows [row0, row0 + R) of a row-major [n_rows, D] matrix into shared
// memory (stride D + 1) as float; rows past n_rows are zero. With
// fold != 0 each value is multiplied by fold and rounded back to T.
template <typename T, int D, int R>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int n_rows, float fold) {
  for (int i = threadIdx.x; i < R * D; i += NT) {
    const int r = i / D;
    const int c = i % D;
    float x = 0.f;
    if (row0 + r < n_rows) {
      x = to_f(src[static_cast<int64_t>(row0 + r) * D + c]);
      if (fold != 0.f) x = round_to<T>(x * fold);
    }
    dst[r * (D + 1) + c] = x;
  }
}

// True when queries [q_first, q_first + nq) and keys [k_first, k_first +
// nk) (global positions; the keys from local row k0) need no mask: every
// key in range, and (causal) every key at or before every query and none
// behind the window.
__device__ __forceinline__ bool block_full(int q_first, int nq, int k_first,
                                           int k0, int nk, int tk, int causal,
                                           int window) {
  if (k0 + nk > tk) return false;
  if (!causal) return true;
  return k_first + nk - 1 <= q_first &&
         (window <= 0 || q_first + nq - 1 - k_first < window);
}

// The same for a SIMT kernel's (BQ-row q tile, BK-row k tile) pair.
__device__ __forceinline__ bool tile_full(int q_first, int k_first, int k0,
                                          int tk, int causal, int window) {
  return block_full(q_first, BQ, k_first, k0, BK, tk, causal, window);
}

__device__ __forceinline__ bool visible(int qp, int kp, int causal,
                                        int window) {
  return !causal || (qp >= kp && (window <= 0 || qp - kp < window));
}

// The KV tiles (bk rows each) that queries [q_first, q_first + nq) may
// see, as [x, y]: the band's first tile for the first query to the
// diagonal tile of the last (every tile without causal); x > y when none.
__device__ __forceinline__ int2 live_kv_tiles(int q_first, int nq, int tk,
                                              int bk, int k_off, int causal,
                                              int window) {
  int lo = 0, hi = (tk + bk - 1) / bk - 1;
  if (causal) {
    hi = min(hi, floor_div(q_first + nq - 1 - k_off, bk));
    if (window > 0)
      lo = max(0, floor_div(q_first - (window - 1) - k_off, bk));
  }
  return make_int2(lo, hi);
}

// s[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over two
// shared-memory tiles of stride D + 1. With FOLD, A is rounded through
// a_fold first (the backward's recompute of the forward's folded q).
template <typename T, int D, bool FOLD>
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* a,
                                         const float* b, float a_fold) {
  constexpr int LD = D + 1;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = a[(ty + 16 * i) * LD + d];
      if (FOLD) av[i] = round_to<T>(av[i] * a_fold);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// acc[i][jd] += sum_c P[c][ty + 16 i] * X[c][tx + 16 jd] when TRANS_P
// (P is [64 x 64] with stride PLD, indexed [q][k]; the owner rows are k),
// else sum_c P[ty + 16 i][c] * X[c][tx + 16 jd]. X has stride D + 1.
template <int D, bool TRANS_P>
__device__ __forceinline__ void tile_acc(float (&acc)[4][D / 16],
                                         const float* p, const float* x) {
  constexpr int LD = D + 1;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
  for (int c = 0; c < 64; ++c) {
    float pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pv[i] = TRANS_P ? p[c * PLD + ty + 16 * i] : p[(ty + 16 * i) * PLD + c];
#pragma unroll
    for (int jd = 0; jd < D / 16; ++jd) {
      const float xv = x[c * LD + tx + 16 * jd];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][jd] = fmaf(pv[i], xv, acc[i][jd]);
    }
  }
}

// ---------------------------------------------------------------- forward

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ o0,
                     const float* __restrict__ m0,
                     const float* __restrict__ l0, float* __restrict__ o,
                     float* __restrict__ m, float* __restrict__ l, int tq,
                     int tk, int q_heads, int group, int q_off, int k_off,
                     int causal, int window, float fold) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;
  float* qs = smem;             // BQ x LD: folded q
  float* kvs = qs + BQ * LD;    // BK x LD: K, then V
  float* ps = kvs + BK * LD;    // BQ x PLD: p in v's dtype

  const int qt = gridDim.x - 1 - blockIdx.x;  // heavy (late) tiles first
  const int row = blockIdx.y;
  const int kv_row = (row / q_heads) * (q_heads / group) + (row % q_heads) / group;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = qt * BQ;
  const int q_first = q_off + q0;

  const T* qh = q + static_cast<int64_t>(row) * tq * D;
  const T* kh = k + static_cast<int64_t>(kv_row) * tk * D;
  const T* vh = v + static_cast<int64_t>(kv_row) * tk * D;

  load_tile<T, D, BQ>(qs, qh, q0, tq, fold);

  float acc[4][DJ], mrow[4], lrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    const bool in = r < tq;
    const int64_t rr = static_cast<int64_t>(row) * tq + r;
    mrow[i] = in ? m0[rr] * LOG2E_F : 0.f;
    lrow[i] = in ? l0[rr] : 0.f;
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd)
      acc[i][jd] = in ? o0[rr * D + tx + 16 * jd] : 0.f;
  }

  const int2 live = live_kv_tiles(q_first, BQ, tk, BK, k_off, causal, window);
  for (int kt = live.x; kt <= live.y; ++kt) {
    const int k0 = kt * BK;
    const bool full = tile_full(q_first, k_off + k0, k0, tk, causal, window);
    __syncthreads();  // the previous tile's reads of kvs and ps are done
    load_tile<T, D, BK>(kvs, kh, k0, tk, 0.f);
    __syncthreads();
    float s[4][4];
    tile_dot<T, D, false>(s, qs, kvs, 0.f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!full) {
        const int qp = q_first + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kj = k0 + tx + 16 * j;
          if (kj >= tk || !visible(qp, k_off + kj, causal, window))
            s[i][j] = -INFINITY;
        }
      }
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      const float m_new = fmaxf(mrow[i], half_warp_max(mx));
      const float alpha = exp2f(mrow[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        rs += p;
        ps[(ty + 16 * i) * PLD + tx + 16 * j] = round_to<T>(p);
      }
      lrow[i] = lrow[i] * alpha + half_warp_sum(rs);
      mrow[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < DJ; ++jd) acc[i][jd] *= alpha;
    }
    __syncthreads();  // ps written; every read of K done
    load_tile<T, D, BK>(kvs, vh, k0, tk, 0.f);
    __syncthreads();
    tile_acc<D, false>(acc, ps, kvs);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= tq) continue;
    const int64_t rr = static_cast<int64_t>(row) * tq + r;
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) o[rr * D + tx + 16 * jd] = acc[i][jd];
    if (tx == 0) {
      m[rr] = mrow[i] * LN2_F;
      l[rr] = lrow[i];
    }
  }
}

// ------------------------------------------------------------- backward

// P and dS of one (q tile, k tile) pair into shared memory: P rounded to
// v's dtype into ps, dS rounded to q's dtype into dss. qs holds q
// unfolded (folded on the fly), dos dO, ks K, vs V.
template <typename T, int D>
__device__ __forceinline__ void bwd_tile_p_ds(
    float* ps, float* dss, const float* qs, const float* dos,
    const float* ks, const float* vs, const float (&l2)[4],
    const float (&dl)[4], int q_first, int k_first, int k0, int tk,
    int causal, int window, bool full, float fold, float scale) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[4][4], dp[4][4];
  tile_dot<T, D, true>(s, qs, ks, fold);
  tile_dot<T, D, false>(dp, dos, vs, 0.f);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q_first + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kj = k0 + tx + 16 * j;
      float sv = s[i][j];
      if (!full && (kj >= tk || !visible(qp, k_first - k0 + kj, causal, window)))
        sv = NEG_INF_F;
      const float p = exp2f(sv - l2[i]);
      const float ds = p * (dp[i][j] - dl[i]) * scale;
      ps[(ty + 16 * i) * PLD + tx + 16 * j] = round_to<T>(p);
      dss[(ty + 16 * i) * PLD + tx + 16 * j] = round_to<T>(ds);
    }
  }
}

// The logsumexp (log2 units) and delta of this thread's four rows.
__device__ __forceinline__ void load_row_stats(float (&l2)[4], float (&dl)[4],
                                               const float* L,
                                               const float* delta,
                                               int64_t row_base, int q0,
                                               int tq) {
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    const bool in = r < tq;
    l2[i] = in ? L[row_base + r] * LOG2E_F : 0.f;
    dl[i] = in ? delta[row_base + r] : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ L,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int tq, int tk, int q_heads, int group, int q_off,
                          int k_off, int causal, int window, float fold,
                          float scale) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;
  float* ks = smem;            // BK x LD
  float* vs = ks + BK * LD;    // BK x LD
  float* qs = vs + BK * LD;    // BQ x LD: q unfolded
  float* dos = qs + BQ * LD;   // BQ x LD
  float* ps = dos + BQ * LD;   // BQ x PLD
  float* dss = ps + BQ * PLD;  // BQ x PLD

  const int kt = blockIdx.x;
  const int kv_row = blockIdx.y;
  const int h_kv = q_heads / group;
  const int b = kv_row / h_kv;
  const int hk = kv_row % h_kv;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = kt * BK;
  const int k_first = k_off + k0;

  const int64_t kv_base = static_cast<int64_t>(kv_row) * tk * D;
  load_tile<T, D, BK>(ks, k + kv_base, k0, tk, 0.f);
  load_tile<T, D, BK>(vs, v + kv_base, k0, tk, 0.f);

  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) dk_acc[i][jd] = dv_acc[i][jd] = 0.f;

  const int n_q = (tq + BQ - 1) / BQ;
  int qt_lo = 0, qt_hi = n_q - 1;
  if (causal) {
    qt_lo = max(0, floor_div(k_first - q_off, BQ));
    if (window > 0)
      qt_hi = min(qt_hi, floor_div(k_first + BK - 1 + window - 1 - q_off, BQ));
  }
  for (int g = 0; g < group; ++g) {
    const int row = b * q_heads + hk * group + g;
    const int64_t row_base = static_cast<int64_t>(row) * tq;
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int q0 = qt * BQ;
      const int q_first = q_off + q0;
      const bool full = tile_full(q_first, k_first, k0, tk, causal, window);
      __syncthreads();  // the previous pair's reads of qs/dos/ps/dss done
      load_tile<T, D, BQ>(qs, q + row_base * D, q0, tq, 0.f);
      load_tile<T, D, BQ>(dos, dout + row_base * D, q0, tq, 0.f);
      float l2[4], dl[4];
      load_row_stats(l2, dl, L, delta, row_base, q0, tq);
      __syncthreads();
      bwd_tile_p_ds<T, D>(ps, dss, qs, dos, ks, vs, l2, dl, q_first,
                          k_first, k0, tk, causal, window, full, fold,
                          scale);
      __syncthreads();
      tile_acc<D, true>(dv_acc, ps, dos);   // dV += P^T dO
      tile_acc<D, true>(dk_acc, dss, qs);   // dK += dS^T Q
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= tk) continue;
    const int64_t rr = (static_cast<int64_t>(kv_row) * tk + r) * D;
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) {
      dk[rr + tx + 16 * jd] = dk_acc[i][jd];
      dv[rr + tx + 16 * jd] = dv_acc[i][jd];
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ L,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int tq, int tk, int q_heads,
                        int group, int q_off, int k_off, int causal,
                        int window, float fold, float scale) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;
  float* qs = smem;            // BQ x LD: q unfolded
  float* dos = qs + BQ * LD;   // BQ x LD
  float* ks = dos + BQ * LD;   // BK x LD
  float* vs = ks + BK * LD;    // BK x LD
  float* ps = vs + BK * LD;    // BQ x PLD: P, written by the shared
  // tile routine, not read by this pass
  float* dss = ps + BQ * PLD;  // BQ x PLD

  const int qt = gridDim.x - 1 - blockIdx.x;  // heavy (late) tiles first
  const int row = blockIdx.y;
  const int kv_row = (row / q_heads) * (q_heads / group) + (row % q_heads) / group;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = qt * BQ;
  const int q_first = q_off + q0;
  const int64_t row_base = static_cast<int64_t>(row) * tq;
  const int64_t kv_base = static_cast<int64_t>(kv_row) * tk * D;

  load_tile<T, D, BQ>(qs, q + row_base * D, q0, tq, 0.f);
  load_tile<T, D, BQ>(dos, dout + row_base * D, q0, tq, 0.f);
  float l2[4], dl[4];
  load_row_stats(l2, dl, L, delta, row_base, q0, tq);

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) acc[i][jd] = 0.f;

  const int2 live = live_kv_tiles(q_first, BQ, tk, BK, k_off, causal, window);
  for (int kt = live.x; kt <= live.y; ++kt) {
    const int k0 = kt * BK;
    const int k_first = k_off + k0;
    const bool full = tile_full(q_first, k_first, k0, tk, causal, window);
    __syncthreads();  // the previous tile's reads of ks/vs/dss done
    load_tile<T, D, BK>(ks, k + kv_base, k0, tk, 0.f);
    load_tile<T, D, BK>(vs, v + kv_base, k0, tk, 0.f);
    __syncthreads();
    bwd_tile_p_ds<T, D>(ps, dss, qs, dos, ks, vs, l2, dl, q_first, k_first,
                        k0, tk, causal, window, full, fold, scale);
    __syncthreads();
    tile_acc<D, false>(acc, dss, ks);  // dQ += dS K
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= tq) continue;
    const int64_t rr = (row_base + r) * D;
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) dq[rr + tx + 16 * jd] = acc[i][jd];
  }
}

// ------------------------------------------- bf16 on the tensor cores
//
// The bf16 forward, dK/dV and dq kernels. Every product of the function
// is bf16 x bf16 summed in float32 (q folded and rounded on load, p
// rounded to v's dtype, ds to q's or k's), which is what wgmma
// .f32.bf16.bf16 computes, so these kernels keep the plain versions'
// function and change only the order of float32 sums. Tiles stay bf16 in
// shared memory in the swizzled layout of sm90.cuh; KV (forward, dq) or
// Q/dO/L/delta (dK/dV) tiles come through a two-stage cp.async ring, the
// next tile's copy in flight while the current one computes; products
// run on wgmma with the float32 accumulators in registers, and a result
// that feeds the next product (P, dS, dS^T) goes from accumulator to A
// operand without leaving registers. One warpgroup owns 64 rows (queries
// in the forward and dq, keys in dK/dV) and skips, with a uniform
// branch, a tile its rows see none of. Tile sizes are compile-time
// (TP_FWD_*, TP_BWD_*, TP_DQ_*, measured by flash_tiles.py).

#ifndef TP_FWD_WG
#define TP_FWD_WG 2     // forward warpgroups: BQ = 64 x TP_FWD_WG q rows
#endif
#ifndef TP_FWD_BK
#define TP_FWD_BK 64    // forward KV tile rows
#endif
// Forward CTAs an SM asked of ptxas: at D 128 a cap of 128 registers
// (a few bytes of spill), faster than one CTA with 148 registers.
#ifndef TP_FWD_MINB
#define TP_FWD_MINB 2
#endif
#ifndef TP_BWD_WG
#define TP_BWD_WG 2     // dK/dV warpgroups: BK = 64 x TP_BWD_WG key rows
#endif
#ifndef TP_BWD_BQ
#define TP_BWD_BQ 64    // dK/dV q tile rows
#endif
#ifndef TP_BWD_MINB
#define TP_BWD_MINB 1
#endif
#ifndef TP_DQ_WG
#define TP_DQ_WG 2      // dq warpgroups: BQ = 64 x TP_DQ_WG q rows
#endif
#ifndef TP_DQ_BK
#define TP_DQ_BK 64     // dq KV tile rows
#endif
#ifndef TP_DQ_MINB
#define TP_DQ_MINB 1
#endif

using bf16 = __nv_bfloat16;

// Dynamic shared memory from its first 1024-byte boundary (the launch
// asks for 1024 bytes more than the tiles need).
__device__ __forceinline__ uint8_t* smem_1024() {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t a = sm90::smem_u32(smem_raw);
  return smem_raw + ((1024u - (a & 1023u)) & 1023u);
}

// Rows [row0, row0 + R) of a row-major [n_rows, D] bf16 matrix into a
// swizzled tile, 16 bytes a cp.async; rows past n_rows are zeros.
template <int R, int D, int NT>
__device__ __forceinline__ void load_tile_async(uint8_t* dst, const bf16* src,
                                                int row0, int n_rows) {
  using TL = sm90::Tile<R, D>;
  constexpr int CH = D / 8;
  const uint32_t base = sm90::smem_u32(dst);
  for (int i = threadIdx.x; i < R * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const bool in = row0 + r < n_rows;
    const bf16* s = src + static_cast<int64_t>(in ? row0 + r : 0) * D + c * 8;
    sm90::cp_async16(base + TL::chunk(r, c), s, in ? 16 : 0);
  }
}

// 8 bf16 times fold, each rounded back to bf16.
__device__ __forceinline__ uint4 fold8(uint4 x, float fold) {
  bf16* e = reinterpret_cast<bf16*>(&x);
#pragma unroll
  for (int u = 0; u < 8; ++u)
    e[u] = __float2bfloat16_rn(__bfloat162float(e[u]) * fold);
  return x;
}

// Rows [q0, q0 + R) of a row-major [tq, D] bf16 q into a swizzled tile,
// each value times fold and rounded back to bf16 (plain loads and
// stores); rows past tq are zeros.
template <int R, int D, int NT>
__device__ __forceinline__ void load_q_folded(uint8_t* dst, const bf16* qh,
                                              int q0, int tq, float fold) {
  using TL = sm90::Tile<R, D>;
  for (int i = threadIdx.x; i < R * D / 8; i += NT) {
    const int r = i / (D / 8), c = i % (D / 8);
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < tq)
      x = fold8(*reinterpret_cast<const uint4*>(
                    qh + static_cast<int64_t>(q0 + r) * D + c * 8),
                fold);
    *reinterpret_cast<uint4*>(dst + TL::chunk(r, c)) = x;
  }
}

template <int D, int WG, int BK, int MINB>
__global__ void __launch_bounds__(128 * WG, MINB)
    flash_fwd_kernel_wgmma(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const float* __restrict__ o0,
                           const float* __restrict__ m0,
                           const float* __restrict__ l0,
                           float* __restrict__ o, float* __restrict__ m,
                           float* __restrict__ l, int tq, int tk,
                           int q_heads, int group, int q_off, int k_off,
                           int causal, int window, float fold) {
  constexpr int NT = 128 * WG;
  constexpr int BQT = 64 * WG;
  using QT = sm90::Tile<BQT, D>;
  using KT = sm90::Tile<BK, D>;
  uint8_t* qs = smem_1024();              // folded q
  uint8_t* kvs = qs + QT::BYTES;          // stage s: K, then V

  const int qt = gridDim.x - 1 - blockIdx.x;  // heavy (late) tiles first
  const int row = blockIdx.y;
  const int kv_row =
      (row / q_heads) * (q_heads / group) + (row % q_heads) / group;
  const int q0 = qt * BQT;
  const int q_first = q_off + q0;
  const bf16* qh = q + static_cast<int64_t>(row) * tq * D;
  const bf16* kh = k + static_cast<int64_t>(kv_row) * tk * D;
  const bf16* vh = v + static_cast<int64_t>(kv_row) * tk * D;

  const int2 cta = live_kv_tiles(q_first, BQT, tk, BK, k_off, causal, window);
  const int kt_lo = cta.x, kt_hi = cta.y;  // the CTA's live KV tiles
  auto load_kv = [&](int kt, int stage) {
    uint8_t* ks = kvs + 2 * stage * KT::BYTES;
    load_tile_async<BK, D, NT>(ks, kh, kt * BK, tk);
    load_tile_async<BK, D, NT>(ks + KT::BYTES, vh, kt * BK, tk);
    sm90::cp_async_commit();
  };
  if (kt_lo <= kt_hi) load_kv(kt_lo, 0);

  // q, folded and rounded once, while the first KV tile is in flight.
  load_q_folded<BQT, D, NT>(qs, qh, q0, tq, fold);
  sm90::fence_async_smem();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32, w = (threadIdx.x % 128) / 32;
  const int g = lane / 4, t = lane % 4;
  const int wq0 = q0 + 64 * wg;  // this warpgroup's first row
  const int wq_first = q_off + wq0;
  const int2 wl = live_kv_tiles(wq_first, 64, tk, BK, k_off, causal, window);
  const int w_lo = wl.x, w_hi = wq0 < tq ? wl.y : -1;  // and its live tiles

  // The carry, in the accumulator layout; m in log2 units. l is a
  // per-thread partial row sum (the quad's t == 0 starts from l0),
  // reduced over the quad at the end.
  float acc[D / 2], mrow[2], lrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wq0 + 16 * w + g + 8 * h;
    const bool in = r < tq;
    const int64_t rr = static_cast<int64_t>(row) * tq + r;
    mrow[h] = in ? m0[rr] * LOG2E_F : 0.f;
    lrow[h] = in && t == 0 ? l0[rr] : 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      float2 x = make_float2(0.f, 0.f);
      if (in) x = *reinterpret_cast<const float2*>(o0 + rr * D + 8 * j + 2 * t);
      acc[4 * j + 2 * h] = x.x;
      acc[4 * j + 2 * h + 1] = x.y;
    }
  }

  const uint32_t qb = sm90::smem_u32(qs);
  int stage = 0;
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    if (kt < kt_hi) {
      load_kv(kt + 1, stage ^ 1);
      sm90::cp_async_wait<1>();
    } else {
      sm90::cp_async_wait<0>();
    }
    sm90::fence_async_smem();
    __syncthreads();  // tile kt (and q) visible to every warpgroup
    if (kt >= w_lo && kt <= w_hi) {
      const uint32_t kb = sm90::smem_u32(kvs + 2 * stage * KT::BYTES);
      const uint32_t vb = kb + KT::BYTES;
      const int k0 = kt * BK;
      // S = Qf . K^T (log2 units)
      float s[BK / 2];
      sm90::wgmma_fence();
      sm90::wgmma_ss_init<BK>(s, QT::desc_k(qb, 64 * wg, 0),
                              KT::desc_k(kb, 0, 0));
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk)
        sm90::wgmma_ss<BK>(s, QT::desc_k(qb, 64 * wg, kk),
                           KT::desc_k(kb, 0, kk), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      if (!block_full(wq_first, 64, k_off + k0, k0, BK, tk, causal, window)) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kj = k0 + 8 * j + 2 * t + e;
              if (kj >= tk || !visible(wq_first + 16 * w + g + 8 * h,
                                       k_off + kj, causal, window))
                s[4 * j + 2 * h + e] = -INFINITY;
            }
      }
      // Online softmax on the fragment: a row's 16 values sit in the 4
      // threads of a quad.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(mrow[h], mx);
        const float alpha = exp2f(mrow[h] - m_new);
        mrow[h] = m_new;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(s[4 * j + 2 * h + e] - m_new);
            s[4 * j + 2 * h + e] = p;
            rs += p;
          }
        lrow[h] = lrow[h] * alpha + rs;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[4 * j + 2 * h] *= alpha;
          acc[4 * j + 2 * h + 1] *= alpha;
        }
      }
      // O += P . V, P rounded to bf16 in registers
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) sm90::acc_to_a(pa[kk], s, kk);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        sm90::wgmma_rs<D>(acc, pa[kk], KT::desc_mn(vb, kk), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
    }
    __syncthreads();  // every read of this stage done before its refill
    stage ^= 1;
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lrow[h] += __shfl_xor_sync(0xffffffffu, lrow[h], 1);
    lrow[h] += __shfl_xor_sync(0xffffffffu, lrow[h], 2);
    const int r = wq0 + 16 * w + g + 8 * h;
    if (r >= tq) continue;
    const int64_t rr = static_cast<int64_t>(row) * tq + r;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(o + rr * D + 8 * j + 2 * t) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    if (t == 0) {
      m[rr] = mrow[h] * LN2_F;
      l[rr] = lrow[h];
    }
  }
}

// dK/dV, transposed so every product is a wgmma with the keys as M:
//   S^T = K . Qf^T and dP^T = V . dO^T   (A: K or V rows, B: Qf or dO,
//                                          both K-major over D)
//   P^T = exp2(S^T - L log2e), dS^T = P^T o (dP^T - delta) scale
//   dV += P^T . dO and dK += dS^T . Q    (A: registers, B: dO or Q
//                                          MN-major)
// L and delta vary along the columns and come from shared memory. The
// unfolded q tile lands by cp.async; a pass folds it into a second tile.
template <int D, int WG, int BQ, int MINB>
__global__ void __launch_bounds__(128 * WG, MINB)
    flash_bwd_dkdv_kernel_wgmma(const bf16* __restrict__ q,
                                const bf16* __restrict__ k,
                                const bf16* __restrict__ v,
                                const bf16* __restrict__ dout,
                                const float* __restrict__ L,
                                const float* __restrict__ delta,
                                float* __restrict__ dk,
                                float* __restrict__ dv, int tq, int tk,
                                int q_heads, int group, int q_off, int k_off,
                                int causal, int window, float fold,
                                float scale) {
  constexpr int NT = 128 * WG;
  constexpr int BKT = 64 * WG;
  using KT = sm90::Tile<BKT, D>;
  using QT = sm90::Tile<BQ, D>;
  uint8_t* ks = smem_1024();
  uint8_t* vs = ks + KT::BYTES;
  uint8_t* qfs = vs + KT::BYTES;          // folded q of the current tile
  uint8_t* qs = qfs + QT::BYTES;          // stage s: q at qs + 2 s QT::BYTES,
                                          // dO after it
  float* ls = reinterpret_cast<float*>(qs + 4 * QT::BYTES);  // [2][BQ]
  float* dls = ls + 2 * BQ;                                   // [2][BQ]

  const int kt = blockIdx.x;
  const int kv_row = blockIdx.y;
  const int h_kv = q_heads / group;
  const int b = kv_row / h_kv;
  const int hk = kv_row % h_kv;
  const int k0 = kt * BKT;
  const int k_first = k_off + k0;
  const int64_t kv_base = static_cast<int64_t>(kv_row) * tk * D;
  load_tile_async<BKT, D, NT>(ks, k + kv_base, k0, tk);
  load_tile_async<BKT, D, NT>(vs, v + kv_base, k0, tk);

  // The CTA's live q tiles: from the diagonal of its first key to the
  // band's end for its last.
  const int n_q = (tq + BQ - 1) / BQ;
  int qt_lo = 0, qt_hi = n_q - 1;
  if (causal) {
    qt_lo = max(0, floor_div(k_first - q_off, BQ));
    if (window > 0)
      qt_hi = min(qt_hi, floor_div(k_first + BKT - 1 + window - 1 - q_off, BQ));
  }
  const int n_live = max(0, qt_hi - qt_lo + 1);
  const int items = group * n_live;  // (query head of the group, q tile)
  auto load_item = [&](int it, int stage) {
    const int row = b * q_heads + hk * group + it / n_live;
    const int q0 = (qt_lo + it % n_live) * BQ;
    const int64_t rb = static_cast<int64_t>(row) * tq;
    uint8_t* qst = qs + 2 * stage * QT::BYTES;
    load_tile_async<BQ, D, NT>(qst, q + rb * D, q0, tq);
    load_tile_async<BQ, D, NT>(qst + QT::BYTES, dout + rb * D, q0, tq);
    for (int i = threadIdx.x; i < BQ; i += NT) {
      const bool in = q0 + i < tq;
      const int64_t at = rb + (in ? q0 + i : 0);
      sm90::cp_async4(sm90::smem_u32(ls + stage * BQ + i), L + at, in ? 4 : 0);
      sm90::cp_async4(sm90::smem_u32(dls + stage * BQ + i), delta + at,
                      in ? 4 : 0);
    }
  };
  if (items > 0) load_item(0, 0);
  sm90::cp_async_commit();  // K, V and the first q tile

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32, w = (threadIdx.x % 128) / 32;
  const int g = lane / 4, t = lane % 4;
  const int wk0 = k0 + 64 * wg;  // this warpgroup's first key
  const int wk_first = k_off + wk0;
  int w_lo = 0, w_hi = n_q - 1;  // and its live q tiles
  if (causal) {
    w_lo = max(0, floor_div(wk_first - q_off, BQ));
    if (window > 0)
      w_hi = min(w_hi, floor_div(wk_first + 63 + window - 1 - q_off, BQ));
  }
  if (wk0 >= tk) w_hi = -1;

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const uint32_t kb = sm90::smem_u32(ks), vb = sm90::smem_u32(vs);
  const uint32_t qfb = sm90::smem_u32(qfs);
  int stage = 0;
  for (int it = 0; it < items; ++it) {
    if (it + 1 < items) {
      load_item(it + 1, stage ^ 1);
      sm90::cp_async_commit();
      sm90::cp_async_wait<1>();
    } else {
      sm90::cp_async_wait<0>();
    }
    __syncthreads();  // this stage's q tile visible to every thread
    uint8_t* qst = qs + 2 * stage * QT::BYTES;
    for (int i = threadIdx.x; i < BQ * D / 8; i += NT) {
      const int off = QT::chunk(i / (D / 8), i % (D / 8));
      *reinterpret_cast<uint4*>(qfs + off) =
          fold8(*reinterpret_cast<const uint4*>(qst + off), fold);
    }
    sm90::fence_async_smem();
    __syncthreads();  // the folded tile, and every cp.async, visible to wgmma
    const int qt = qt_lo + it % n_live;
    if (qt >= w_lo && qt <= w_hi) {
      const uint32_t qb = sm90::smem_u32(qst), dob = qb + QT::BYTES;
      const int q_first = q_off + qt * BQ;
      float st[BQ / 2], dpt[BQ / 2];
      sm90::wgmma_fence();
      sm90::wgmma_ss_init<BQ>(st, KT::desc_k(kb, 64 * wg, 0),
                              QT::desc_k(qfb, 0, 0));
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk)
        sm90::wgmma_ss<BQ>(st, KT::desc_k(kb, 64 * wg, kk),
                           QT::desc_k(qfb, 0, kk), 1);
      sm90::wgmma_ss_init<BQ>(dpt, KT::desc_k(vb, 64 * wg, 0),
                              QT::desc_k(dob, 0, 0));
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk)
        sm90::wgmma_ss<BQ>(dpt, KT::desc_k(vb, 64 * wg, kk),
                           QT::desc_k(dob, 0, kk), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      const bool full =
          block_full(q_first, BQ, wk_first, wk0, 64, tk, causal, window);
      const float* lst = ls + stage * BQ;
      const float* dlst = dls + stage * BQ;
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t + e;  // q column
          const float l2 = lst[c] * LOG2E_F, dl = dlst[c];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * h + e;
            const int kj = wk0 + 16 * w + g + 8 * h;  // key row
            float sv = st[i];
            if (!full && (kj >= tk || !visible(q_first + c, k_off + kj,
                                               causal, window)))
              sv = NEG_INF_F;
            const float p = exp2f(sv - l2);
            st[i] = p;
            dpt[i] = p * (dpt[i] - dl) * scale;
          }
        }
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        sm90::acc_to_a(pa[kk], st, kk);
        sm90::acc_to_a(da[kk], dpt, kk);
      }
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        sm90::wgmma_rs<D>(dv_acc, pa[kk], QT::desc_mn(dob, kk), 1);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        sm90::wgmma_rs<D>(dk_acc, da[kk], QT::desc_mn(qb, kk), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
    }
    __syncthreads();  // every read of this stage done before its refill
    stage ^= 1;
  }
  sm90::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kj = wk0 + 16 * w + g + 8 * h;
    if (kj >= tk) continue;
    const int64_t rr = (static_cast<int64_t>(kv_row) * tk + kj) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(dk + rr + 8 * j + 2 * t) =
          make_float2(dk_acc[4 * j + 2 * h], dk_acc[4 * j + 2 * h + 1]);
      *reinterpret_cast<float2*>(dv + rr + 8 * j + 2 * t) =
          make_float2(dv_acc[4 * j + 2 * h], dv_acc[4 * j + 2 * h + 1]);
    }
  }
}

// dq, the forward's shape with the backward's elementwise step between
// its two products (FlashAttention-2's dq pass). The folded q tile and
// the dO tile stay resident; K/V tiles come through the ring.
//   S = Qf . K^T and dP = dO . V^T   (A: Qf or dO rows, B: K or V, both
//                                     K-major over D)
//   P = exp2(S - L log2e), dS = P o (dP - delta) scale
//   dQ += dS . K                      (A: registers, B: the same K tile
//                                     read MN-major)
// Queries are M, so L and delta vary along the fragment's rows: each
// thread holds its two rows' values in registers.
template <int D, int WG, int BK, int MINB>
__global__ void __launch_bounds__(128 * WG, MINB)
    flash_bwd_dq_kernel_wgmma(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ dout,
                              const float* __restrict__ L,
                              const float* __restrict__ delta,
                              float* __restrict__ dq, int tq, int tk,
                              int q_heads, int group, int q_off, int k_off,
                              int causal, int window, float fold,
                              float scale) {
  constexpr int NT = 128 * WG;
  constexpr int BQT = 64 * WG;
  using QT = sm90::Tile<BQT, D>;
  using KT = sm90::Tile<BK, D>;
  uint8_t* qs = smem_1024();              // folded q
  uint8_t* dos = qs + QT::BYTES;          // dO
  uint8_t* kvs = dos + QT::BYTES;         // stage s: K, then V

  const int qt = gridDim.x - 1 - blockIdx.x;  // heavy (late) tiles first
  const int row = blockIdx.y;
  const int kv_row =
      (row / q_heads) * (q_heads / group) + (row % q_heads) / group;
  const int q0 = qt * BQT;
  const int q_first = q_off + q0;
  const int64_t row_base = static_cast<int64_t>(row) * tq;
  const bf16* qh = q + row_base * D;
  const bf16* kh = k + static_cast<int64_t>(kv_row) * tk * D;
  const bf16* vh = v + static_cast<int64_t>(kv_row) * tk * D;

  const int2 cta = live_kv_tiles(q_first, BQT, tk, BK, k_off, causal, window);
  const int kt_lo = cta.x, kt_hi = cta.y;  // the CTA's live KV tiles
  auto load_kv = [&](int kt, int stage) {
    uint8_t* ks = kvs + 2 * stage * KT::BYTES;
    load_tile_async<BK, D, NT>(ks, kh, kt * BK, tk);
    load_tile_async<BK, D, NT>(ks + KT::BYTES, vh, kt * BK, tk);
    sm90::cp_async_commit();
  };
  if (kt_lo <= kt_hi) {  // dO lands with the first KV tile
    load_tile_async<BQT, D, NT>(dos, dout + row_base * D, q0, tq);
    load_kv(kt_lo, 0);
  }

  // q, folded and rounded once, while the first tiles are in flight.
  load_q_folded<BQT, D, NT>(qs, qh, q0, tq, fold);
  sm90::fence_async_smem();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32, w = (threadIdx.x % 128) / 32;
  const int g = lane / 4, t = lane % 4;
  const int wq0 = q0 + 64 * wg;  // this warpgroup's first row
  const int wq_first = q_off + wq0;
  const int2 wl = live_kv_tiles(wq_first, 64, tk, BK, k_off, causal, window);
  const int w_lo = wl.x, w_hi = wq0 < tq ? wl.y : -1;  // and its live tiles

  // This thread's rows 16 w + g and 16 w + g + 8: L (log2 units) and
  // delta; rows past Tq read 0 (computed, never written).
  float l2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wq0 + 16 * w + g + 8 * h;
    const bool in = r < tq;
    l2[h] = in ? L[row_base + r] * LOG2E_F : 0.f;
    dl[h] = in ? delta[row_base + r] : 0.f;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const uint32_t qb = sm90::smem_u32(qs), dob = sm90::smem_u32(dos);
  int stage = 0;
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    if (kt < kt_hi) {
      load_kv(kt + 1, stage ^ 1);
      sm90::cp_async_wait<1>();
    } else {
      sm90::cp_async_wait<0>();
    }
    sm90::fence_async_smem();
    __syncthreads();  // tile kt (and q, dO) visible to every warpgroup
    if (kt >= w_lo && kt <= w_hi) {
      const uint32_t kb = sm90::smem_u32(kvs + 2 * stage * KT::BYTES);
      const uint32_t vb = kb + KT::BYTES;
      const int k0 = kt * BK;
      float s[BK / 2], dp[BK / 2];
      sm90::wgmma_fence();
      sm90::wgmma_ss_init<BK>(s, QT::desc_k(qb, 64 * wg, 0),
                              KT::desc_k(kb, 0, 0));
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk)
        sm90::wgmma_ss<BK>(s, QT::desc_k(qb, 64 * wg, kk),
                           KT::desc_k(kb, 0, kk), 1);
      sm90::wgmma_ss_init<BK>(dp, QT::desc_k(dob, 64 * wg, 0),
                              KT::desc_k(vb, 0, 0));
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk)
        sm90::wgmma_ss<BK>(dp, QT::desc_k(dob, 64 * wg, kk),
                           KT::desc_k(vb, 0, kk), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      const bool full =
          block_full(wq_first, 64, k_off + k0, k0, BK, tk, causal, window);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            const int kj = k0 + 8 * j + 2 * t + e;  // key row
            float sv = s[i];
            if (!full && (kj >= tk || !visible(wq_first + 16 * w + g + 8 * h,
                                               k_off + kj, causal, window)))
              sv = NEG_INF_F;
            s[i] = exp2f(sv - l2[h]) * (dp[i] - dl[h]) * scale;  // dS
          }
      // dQ += dS . K, dS rounded to bf16 in registers
      uint32_t da[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) sm90::acc_to_a(da[kk], s, kk);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        sm90::wgmma_rs<D>(acc, da[kk], KT::desc_mn(kb, kk), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
    }
    __syncthreads();  // every read of this stage done before its refill
    stage ^= 1;
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wq0 + 16 * w + g + 8 * h;
    if (r >= tq) continue;
    const int64_t rr = (row_base + r) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dq + rr + 8 * j + 2 * t) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

// -------------------------------------------------------------- launches

template <int D>
constexpr size_t fwd_smem() {
  return static_cast<size_t>(BQ * (D + 1) + BK * (D + 1) + BQ * PLD) *
         sizeof(float);
}
template <int D>
constexpr size_t bwd_smem() {
  return static_cast<size_t>(2 * BQ * (D + 1) + 2 * BK * (D + 1) +
                             2 * BQ * PLD) *
         sizeof(float);
}

struct Args {
  const void *q, *k, *v, *x, *y, *z;  // fwd: o0 m0 l0; bwd: dout L delta
  void *out0, *out1, *out2;
  int rows, tq, tk, q_heads, group, q_off, k_off, causal, window;
  float fold, scale;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_fwd(const Args& a) {
  const size_t smem = fwd_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.tq + BQ - 1) / BQ, a.rows);
  flash_fwd_kernel<T, D><<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.x),
      static_cast<const float*>(a.y), static_cast<const float*>(a.z),
      static_cast<float*>(a.out0), static_cast<float*>(a.out1),
      static_cast<float*>(a.out2), a.tq, a.tk, a.q_heads, a.group, a.q_off,
      a.k_off, a.causal, a.window, a.fold);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkdv(const Args& a) {
  const size_t smem = bwd_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.tk + BK - 1) / BK, a.rows);
  flash_bwd_dkdv_kernel<T, D><<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.x),
      static_cast<const float*>(a.y), static_cast<const float*>(a.z),
      static_cast<float*>(a.out0), static_cast<float*>(a.out1), a.tq, a.tk,
      a.q_heads, a.group, a.q_off, a.k_off, a.causal, a.window, a.fold,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dq(const Args& a) {
  const size_t smem = bwd_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.tq + BQ - 1) / BQ, a.rows);
  flash_bwd_dq_kernel<T, D><<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.x),
      static_cast<const float*>(a.y), static_cast<const float*>(a.z),
      static_cast<float*>(a.out0), a.tq, a.tk, a.q_heads, a.group, a.q_off,
      a.k_off, a.causal, a.window, a.fold, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
constexpr int fwd_tc_smem() {
  return 1024 + sm90::Tile<64 * TP_FWD_WG, D>::BYTES +
         4 * sm90::Tile<TP_FWD_BK, D>::BYTES;
}
template <int D>
constexpr int dkdv_tc_smem() {
  return 1024 + 2 * sm90::Tile<64 * TP_BWD_WG, D>::BYTES +
         5 * sm90::Tile<TP_BWD_BQ, D>::BYTES + 4 * TP_BWD_BQ * 4;
}
template <int D>
constexpr int dq_tc_smem() {
  return 1024 + 2 * sm90::Tile<64 * TP_DQ_WG, D>::BYTES +
         4 * sm90::Tile<TP_DQ_BK, D>::BYTES;
}

template <int D>
int launch_fwd_tc(const Args& a) {
  auto* kern = flash_fwd_kernel_wgmma<D, TP_FWD_WG, TP_FWD_BK, TP_FWD_MINB>;
  constexpr int smem = fwd_tc_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int bq = 64 * TP_FWD_WG;
  const dim3 grid((a.tq + bq - 1) / bq, a.rows);
  kern<<<grid, 128 * TP_FWD_WG, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const float*>(a.x),
      static_cast<const float*>(a.y), static_cast<const float*>(a.z),
      static_cast<float*>(a.out0), static_cast<float*>(a.out1),
      static_cast<float*>(a.out2), a.tq, a.tk, a.q_heads, a.group, a.q_off,
      a.k_off, a.causal, a.window, a.fold);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkdv_tc(const Args& a) {
  auto* kern =
      flash_bwd_dkdv_kernel_wgmma<D, TP_BWD_WG, TP_BWD_BQ, TP_BWD_MINB>;
  constexpr int smem = dkdv_tc_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int bk = 64 * TP_BWD_WG;
  const dim3 grid((a.tk + bk - 1) / bk, a.rows);
  kern<<<grid, 128 * TP_BWD_WG, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.x),
      static_cast<const float*>(a.y), static_cast<const float*>(a.z),
      static_cast<float*>(a.out0), static_cast<float*>(a.out1), a.tq, a.tk,
      a.q_heads, a.group, a.q_off, a.k_off, a.causal, a.window, a.fold,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq_tc(const Args& a) {
  auto* kern = flash_bwd_dq_kernel_wgmma<D, TP_DQ_WG, TP_DQ_BK, TP_DQ_MINB>;
  constexpr int smem = dq_tc_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int bq = 64 * TP_DQ_WG;
  const dim3 grid((a.tq + bq - 1) / bq, a.rows);
  kern<<<grid, 128 * TP_DQ_WG, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.x),
      static_cast<const float*>(a.y), static_cast<const float*>(a.z),
      static_cast<float*>(a.out0), a.tq, a.tk, a.q_heads, a.group, a.q_off,
      a.k_off, a.causal, a.window, a.fold, a.scale);
  return static_cast<int>(cudaGetLastError());
}

bool args_ok(const Args& a) {
  return a.rows >= 1 && a.tq >= 1 && a.tk >= 1 && a.q_heads >= 1 &&
         a.group >= 1 && a.q_heads % a.group == 0;
}

// The SIMT kernels: float32 only (dtype 0); d: 32, 64 or 128.
template <template <typename, int> class L>
int dispatch(const Args& a, int d, int dtype) {
  if (!args_ok(a) || dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (d == 32) return L<float, 32>::run(a);
  if (d == 64) return L<float, 64>::run(a);
  if (d == 128) return L<float, 128>::run(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

bool aligned(const void* p, uintptr_t n) {
  return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0;
}

// The tensor-core kernels: bfloat16 only (dtype 1), operands on 16-byte
// (bf16) and 8-byte (float32) boundaries.
template <template <int> class L>
int dispatch_tc(const Args& a, int d, int dtype) {
  if (!args_ok(a) || dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned(a.q, 16) || !aligned(a.k, 16) || !aligned(a.v, 16) ||
      !aligned(a.out0, 8) || !aligned(a.out1, 8))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (d == 32) return L<32>::run(a);
  if (d == 64) return L<64>::run(a);
  if (d == 128) return L<128>::run(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int D>
struct Fwd {
  static int run(const Args& a) { return launch_fwd<T, D>(a); }
};
template <typename T, int D>
struct Dkdv {
  static int run(const Args& a) { return launch_dkdv<T, D>(a); }
};
template <typename T, int D>
struct Dq {
  static int run(const Args& a) { return launch_dq<T, D>(a); }
};
template <int D>
struct FwdTc {
  static int run(const Args& a) { return launch_fwd_tc<D>(a); }
};
template <int D>
struct DkdvTc {
  static int run(const Args& a) { return launch_dkdv_tc<D>(a); }
};
template <int D>
struct DqTc {
  static int run(const Args& a) { return launch_dq_tc<D>(a); }
};

// CTAs of kern resident on one SM at this launch's threads and shared
// memory (0 when the card refuses the configuration).
template <typename K>
int ctas_per_sm(K* kern, int threads, int smem) {
  int n = 0;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, threads, smem) !=
          cudaSuccess)
    return 0;
  return n;
}

template <int D>
int config_d(int fn, int dtype, int* out) {
  if (fn == 0 && dtype == 1) {
    out[0] = 64 * TP_FWD_WG, out[1] = TP_FWD_BK, out[2] = 128 * TP_FWD_WG;
    out[3] = fwd_tc_smem<D>();
    out[4] = ctas_per_sm(
        flash_fwd_kernel_wgmma<D, TP_FWD_WG, TP_FWD_BK, TP_FWD_MINB>, out[2],
        out[3]);
  } else if (fn == 1 && dtype == 1) {
    out[0] = TP_BWD_BQ, out[1] = 64 * TP_BWD_WG, out[2] = 128 * TP_BWD_WG;
    out[3] = dkdv_tc_smem<D>();
    out[4] = ctas_per_sm(
        flash_bwd_dkdv_kernel_wgmma<D, TP_BWD_WG, TP_BWD_BQ, TP_BWD_MINB>,
        out[2], out[3]);
  } else if (dtype == 1) {  // fn 2
    out[0] = 64 * TP_DQ_WG, out[1] = TP_DQ_BK, out[2] = 128 * TP_DQ_WG;
    out[3] = dq_tc_smem<D>();
    out[4] = ctas_per_sm(
        flash_bwd_dq_kernel_wgmma<D, TP_DQ_WG, TP_DQ_BK, TP_DQ_MINB>, out[2],
        out[3]);
  } else {  // the SIMT kernels, float32
    out[0] = BQ, out[1] = BK, out[2] = NT;
    out[3] = static_cast<int>(fn == 0 ? fwd_smem<D>() : bwd_smem<D>());
    if (fn == 0) out[4] = ctas_per_sm(flash_fwd_kernel<float, D>, NT, out[3]);
    if (fn == 1)
      out[4] = ctas_per_sm(flash_bwd_dkdv_kernel<float, D>, NT, out[3]);
    if (fn == 2)
      out[4] = ctas_per_sm(flash_bwd_dq_kernel<float, D>, NT, out[3]);
  }
  return 0;
}

}  // namespace

extern "C" int tp_flash_fwd(const void* q, const void* k, const void* v,
                            const void* o0, const void* m0, const void* l0,
                            void* o, void* m, void* l, int rows, int tq,
                            int tk, int d, int q_heads, int group, int q_off,
                            int k_off, int causal, int window, int dtype,
                            float fold, void* stream) {
  const Args a{q,  k,     v,      o0,    m0,     l0,     o,
               m,  l,     rows,   tq,    tk,     q_heads, group,
               q_off, k_off, causal, window, fold, 0.f,
               static_cast<cudaStream_t>(stream)};
  return dispatch<Fwd>(a, d, dtype);
}

extern "C" int tp_flash_fwd_wgmma(const void* q, const void* k, const void* v,
                                  const void* o0, const void* m0,
                                  const void* l0, void* o, void* m, void* l,
                                  int rows, int tq, int tk, int d,
                                  int q_heads, int group, int q_off,
                                  int k_off, int causal, int window,
                                  int dtype, float fold, void* stream) {
  const Args a{q,  k,     v,      o0,    m0,     l0,     o,
               m,  l,     rows,   tq,    tk,     q_heads, group,
               q_off, k_off, causal, window, fold, 0.f,
               static_cast<cudaStream_t>(stream)};
  return dispatch_tc<FwdTc>(a, d, dtype);
}

extern "C" int tp_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* L,
                                 const void* delta, void* dk, void* dv,
                                 int rows, int tq, int tk, int d, int q_heads,
                                 int group, int q_off, int k_off, int causal,
                                 int window, int dtype, float fold,
                                 float scale, void* stream) {
  const Args a{q,  k,     v,      dout,  L,      delta,  dk,
               dv, nullptr, rows, tq,    tk,     q_heads, group,
               q_off, k_off, causal, window, fold, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<Dkdv>(a, d, dtype);
}

extern "C" int tp_flash_bwd_dkdv_wgmma(
    const void* q, const void* k, const void* v, const void* dout,
    const void* L, const void* delta, void* dk, void* dv, int rows, int tq,
    int tk, int d, int q_heads, int group, int q_off, int k_off, int causal,
    int window, int dtype, float fold, float scale, void* stream) {
  const Args a{q,  k,     v,      dout,  L,      delta,  dk,
               dv, nullptr, rows, tq,    tk,     q_heads, group,
               q_off, k_off, causal, window, fold, scale,
               static_cast<cudaStream_t>(stream)};
  if (!aligned(dout, 16)) return static_cast<int>(cudaErrorMisalignedAddress);
  return dispatch_tc<DkdvTc>(a, d, dtype);
}

extern "C" int tp_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* L,
                               const void* delta, void* dq, int rows, int tq,
                               int tk, int d, int q_heads, int group,
                               int q_off, int k_off, int causal, int window,
                               int dtype, float fold, float scale,
                               void* stream) {
  const Args a{q,       k,       v,    dout,  L,      delta,  dq,
               nullptr, nullptr, rows, tq,    tk,     q_heads, group,
               q_off,   k_off,   causal, window, fold, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<Dq>(a, d, dtype);
}

extern "C" int tp_flash_bwd_dq_wgmma(
    const void* q, const void* k, const void* v, const void* dout,
    const void* L, const void* delta, void* dq, int rows, int tq, int tk,
    int d, int q_heads, int group, int q_off, int k_off, int causal,
    int window, int dtype, float fold, float scale, void* stream) {
  const Args a{q,       k,       v,    dout,  L,      delta,  dq,
               nullptr, nullptr, rows, tq,    tk,     q_heads, group,
               q_off,   k_off,   causal, window, fold, scale,
               static_cast<cudaStream_t>(stream)};
  if (!aligned(dout, 16)) return static_cast<int>(cudaErrorMisalignedAddress);
  return dispatch_tc<DqTc>(a, d, dtype);
}

// How a kernel is launched: fn 0 the forward, 1 dK/dV, 2 dq; dtype 0
// float32, 1 bfloat16; d the head dim. out[5] = {q tile rows, k tile
// rows, threads a CTA, dynamic shared bytes a CTA, CTAs resident on an
// SM}. Returns cudaErrorInvalidValue for a combination no kernel takes.
extern "C" int tp_flash_config(int fn, int dtype, int d, int* out) {
  if (fn < 0 || fn > 2 || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (d == 32) return config_d<32>(fn, dtype, out);
  if (d == 64) return config_d<64>(fn, dtype, out);
  if (d == 128) return config_d<128>(fn, dtype, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
