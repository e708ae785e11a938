// Flash attention for Hopper (sm_90a): the hand-written port of the five
// Pallas flash kernels in tpu_p2p/ops/flash_attention.py.
//
//   tp_flash_fwd       replaces _kernel (:101, the rectangular/banded
//     sweep) and _kernel_flat (:208, the live-cell causal sweep): one
//     online-softmax accumulate of q tiles over KV tiles against an
//     (o, m, l) carry, with global offsets, causal, sliding window and
//     GQA (the narrow KV row of _kv_row_map :339).
//   tp_flash_bwd_dkdv  replaces _bwd_dkdv_kernel (:717) and the GQA group
//     sum after it (_flash_bwd :1310-1314): dK, dV from the saved
//     logsumexp, written straight into the narrow [B*Hkv, Tk, D] rows.
//   tp_flash_bwd_dq    replaces _bwd_dq_kernel (:826) and, for the fused
//     causal form, _dq_reduce_kernel (:693) with its partial-dq slabs.
//
// What bounds them: at the training shape (T 4096, D 128) the work is
// O(T^2 D) multiply-adds over O(T D) bytes, so operations, not bytes.
// These kernels do their products as float32 FMAs over shared-memory
// tiles (bf16 inputs are widened on load, which makes every product exact
// as in the reference's preferred_element_type=float32), so their ceiling
// is the card's float32 rate, not its bf16 tensor-core rate; moving the
// products onto wgmma is a later change.
//
// Design. Pallas carries the (o, m, l) and dK/dV/dQ accumulators across a
// sequential grid and revisits output blocks; Hopper runs blocks in
// parallel with nothing carried between them, so the innermost grid
// dimension becomes a loop inside one CTA that keeps its accumulators in
// registers:
//   - fwd and dq: one CTA per (B*Hq row, 64-row q tile), looping over the
//     live KV tiles only: causal ends the loop at the diagonal tile (all
//     that the flat live-cell grid bought on the TPU), a window starts it
//     at the band's first tile (what the banded index map bought). Heavy
//     q tiles (late in a causal sweep) are launched first.
//   - dkdv: one CTA per (B*Hkv row, 64-row k tile), looping over the
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
// Layout: 256 threads as a 16 x 16 grid (ty, tx). A thread owns rows
// ty + 16 i (i < 4) of every 64-row tile and columns tx + 16 j of every
// 64-column score tile or D-wide accumulator, so a row's 16 owners sit in
// one half-warp and reduce with xor-shuffles. Tiles sit in shared memory
// as float with a row stride of D + 1 (no bank conflicts on the column
// walks). Rows past Tq or Tk load as zeros; keys past Tk are masked.
//
// Every entry point runs on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // q rows per tile
constexpr int BK = 64;   // k rows per tile
constexpr int NT = 256;  // threads per CTA
constexpr int PLD = BK + 1;
constexpr float LOG2E_F = 1.4426950408889634f;
constexpr float LN2_F = 0.6931471805599453f;
constexpr float NEG_INF_F = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to T and widened back: the reference's .astype(T) on an f32.
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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

// True when the (q tile, k tile) pair needs no mask: every key in range,
// and (causal) every key at or before every query and none behind the
// window. Positions are global (offsets included).
__device__ __forceinline__ bool tile_full(int q_first, int k_first, int k0,
                                          int tk, int causal, int window) {
  if (k0 + BK > tk) return false;
  if (!causal) return true;
  const int q_last = q_first + BQ - 1;
  const int k_last = k_first + BK - 1;
  return k_last <= q_first && (window <= 0 || q_last - k_first < window);
}

__device__ __forceinline__ bool visible(int qp, int kp, int causal,
                                        int window) {
  return !causal || (qp >= kp && (window <= 0 || qp - kp < window));
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

  const int n_k = (tk + BK - 1) / BK;
  int kt_lo = 0, kt_hi = n_k - 1;
  if (causal) {
    kt_hi = min(kt_hi, floor_div(q_first + BQ - 1 - k_off, BK));
    if (window > 0)
      kt_lo = max(0, floor_div(q_first - (window - 1) - k_off, BK));
  }
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
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

  const int n_k = (tk + BK - 1) / BK;
  int kt_lo = 0, kt_hi = n_k - 1;
  if (causal) {
    kt_hi = min(kt_hi, floor_div(q_first + BQ - 1 - k_off, BK));
    if (window > 0)
      kt_lo = max(0, floor_div(q_first - (window - 1) - k_off, BK));
  }
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
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

// dtype: 0 float32, 1 bfloat16; d: 32, 64 or 128.
template <template <typename, int> class L>
int dispatch(const Args& a, int d, int dtype) {
  if (a.rows < 1 || a.tq < 1 || a.tk < 1 || a.q_heads < 1 || a.group < 1 ||
      a.q_heads % a.group)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    if (d == 32) return L<float, 32>::run(a);
    if (d == 64) return L<float, 64>::run(a);
    if (d == 128) return L<float, 128>::run(a);
  } else if (dtype == 1) {
    if (d == 32) return L<__nv_bfloat16, 32>::run(a);
    if (d == 64) return L<__nv_bfloat16, 64>::run(a);
    if (d == 128) return L<__nv_bfloat16, 128>::run(a);
  }
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
