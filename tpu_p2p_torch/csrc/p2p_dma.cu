// Peer-push permute and fused ship for the ``pallas_dma`` transport, on
// CUDA IPC windows.
//
// Replaces tpu_p2p/parallel/pallas_dma.py::_dma_transport_permute_call
// (kernel body ``dma_transport_ppermute``, :166): one hop of a total
// permutation. The TPU kernel writes straight into the receiver's output
// (make_async_remote_copy(src_ref=in_ref, dst_ref=out_ref), :166-190).
// Here the caller decides per hop where a rank's push lands
// (tpu_p2p_torch/parallel/pallas_dma.py::plan_hop):
//   out   straight into the receiver's output, wherever this process can
//         address it: every edge of a LocalMesh (one process allocated
//         every rank's output) and a self-edge on any mesh. The payload
//         crosses device memory once: x read, the output written, 2 x
//         nbytes of traffic.
//   slab  into the receiver's receive slab, on an edge between two
//         processes: a process's output is private to it, only the slab
//         is IPC-mapped. The receiver copies each segment out as soon as
//         it has landed (4 x nbytes; across cards the copy-out runs on
//         the receiver's own memory while later segments are still on
//         NVLink).
//   none  the receiver's arrival is a dummy edge of the completed
//         permutation (ppermute gives it zeros): no bytes, no flags. The
//         receiver zero-fills its own output.
//
// The symmetric window. Every rank of a group allocates one window per
// capacity with cudaMalloc (not from PyTorch's caching allocator, whose
// IPC handle would name the block's base): a 16 KiB header of flags, then
// the receive slab. The Python side exchanges the cudaIpcMemHandle_t of
// each window over the host group and opens the peers' windows with
// cudaIpcOpenMemHandle; that works between processes on one card and
// between the cards of one host. A rank's own window is its own pointer.
// A LocalMesh's windows are headers alone: no push goes through a slab.
//
// The handshake, with epochs instead of resets. Each launch on a window
// carries the next value ``e`` of the window's counter, the same on every
// rank, so no flag is ever cleared:
//   ready    a rank whose arrival a peer writes stores e into its
//            source's ready[me] at the start of its launch; a rank that
//            pushes into a peer waits until its own ready[dst] reads >= e
//            before its first byte;
//   out      the push CTAs copy x into dst's output, 16-byte vectors four
//            at a time; each CTA, after __syncthreads(), makes one fence
//            and counts itself in (a counter in my header); the last
//            stores e into dst's arrived[me] with release semantics. The
//            arrival is one thread that polls its arrived[src] with
//            acquire loads until it reads >= e: it copies nothing;
//   slab     the push CTAs copy whole segments (contiguous spans of
//            seg_bytes, the last one short) into dst's slab; after each
//            one, thread 0 fences and releases dst's seg[s] = e. The
//            arrival CTAs take the segments in the same order, wait on
//            their own seg[s] >= e and copy that segment out, so no byte
//            waits for the whole buffer;
//   zero     a dummy arrival: the arrival CTAs zero-fill the output.
// A grid splits into push CTAs [0, npush) and arrival CTAs: no CTA waits
// for another of its own launch, only for a peer's.
// Scope. Flags, fences and acquires are at system scope where a peer is
// another process or on another card, and at the card's scope where
// every rank is a stream of this process on one card (a LocalMesh on one
// card). A system-scope release costs microseconds: on one card it set
// half of a 128 KiB ship's device time.
//
// Why no byte lands early or is missed. A receiver's "ready for e" comes
// from its own launch e (the permute kernel, or the fused ship's push
// kernel). That launch runs on the rank's stream, which is ordered after
// the caller's stream (LocalMesh.enter(); on a process mesh it is the
// caller's stream), where the receiver's output for e was allocated, and
// after the rank's launches of every earlier epoch (the ship's side
// stream waits for its own stream, which holds the previous arrival). So
// a sender that reads ready >= e knows that the output block for e is
// allocated and every earlier use of that block on those streams (the
// caching allocator's reuse) is done, and that the receiver has copied
// out every segment of every earlier epoch. No sender writes before it.
// One flag slot per writer keeps epochs of different permutations apart:
// only dst writes my ready[dst], only src my arrived[src]. One seg[]
// array per window is enough: a slab's writer at epoch e writes only
// after the receiver's "ready for e", which the receiver stores only once
// its copy-out of every earlier epoch has finished, so two writers never
// share a slab or its seg[] at once. Flags only grow and every wait asks
// for >= its own epoch, so a dummy edge that skips its bytes and flags
// leaves nothing a later epoch could take for its own, across
// back-to-back calls with changing edge sets.
//
// No hang: every spin is bounded by %globaltimer. Past the bound the
// kernel records the phase, the peer and the epoch in a host-mapped word
// and returns; the wrapper raises TransferTimeout from it. Once one
// thread of a rank has recorded a fault for an epoch, the rank's other
// spins of that epoch give up at once.
// No deadlock inside one launch: CTAs that spin hold their SMs, so the
// grid is never larger than what is resident at once (occupancy x SMs).
//
// The fused ship (dma_ship_compute). The TPU kernel
// (tpu_p2p/parallel/pallas_dma.py::_dma_transport_ship_call, body
// ``dma_transport_ship_compute`` :289) starts the remote copy, runs an
// arbitrary traced compute inside the same kernel body, then waits. A
// PyTorch compute cannot be fused into a CUDA kernel, so the hop is split
// at the point where the TPU kernel puts its compute, into two launches
// on two streams of the rank:
//   dma_ship_push_kernel    (side stream) the ready handshake, the push
//                           (into dst's output on a LocalMesh, into its
//                           slab between processes), a dummy arrival's
//                           zero-fill; after an ``out`` push the last
//                           CTA releases arrived;
//   dma_ship_arrive_kernel  (the rank's own stream, after the compute was
//                           issued there) one warp: waits on
//                           arrived[src]. A LocalMesh's arrival: its
//                           peer stored into the output;
//   dma_ship_copy_kernel    (the same place) a process mesh's arrival:
//                           the permute's segment arrival, each slab
//                           segment copied out once its seg[s] reads the
//                           epoch. The push kernel leaves the copy to it,
//                           so the copy-out runs after the compute and
//                           not beside the push on the side stream.
// Each arrival launches only where a peer writes the rank's arrival. The
// caller orders the side stream after everything its own stream issued
// before (the ship's producer and the previous arrival, which the push's
// ready signal vouches for: the slab's earlier segments are copied out);
// the caller's stream then waits for both of the rank's streams. Two
// launches, not one with a stream join in place of the arrival: traced,
// the kernels and not the joins set a 128 KiB ship's device time
// (PERF.md, section 6).
//
// In-process ranks (a LocalMesh: one process drives several ranks, each
// with its own streams, possibly on one card) run their kernels
// concurrently, not time-sliced as processes are. A spinning grid that
// filled the card would keep a peer's kernel from ever starting, so the
// caller passes ``share``: the grid is at most resident / share CTAs
// (share = 2 x the ranks on the card: every rank's push and arrival fit
// at once with room to spare for the compute). A process mesh's ship
// runs its push and its copy beside its own compute in one context, so
// there share = 4: both fit at once, and half the card stays for the
// compute.
//
// What bounds it: bytes. The function moves the buffer once (read x,
// write the peer's copy: 2 x nbytes over device memory on one card, or
// nbytes over NVLink between cards). An ``out`` push does just that; a
// ``slab`` push adds the copy-out.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarp = 32;
constexpr int kMaxRanks = 64;
constexpr int kMaxSegs = 1024;
constexpr unsigned long long kSegMin = 32768;  // smallest slab segment
constexpr size_t kHeaderBytes = 16384;

// Built with -DTP_DMA_REVERSE_SEGMENTS=1 (a card test only), the push
// CTAs take the slab's segments last first, so they land in the opposite
// order to the one the arrival CTAs take them in.
#ifndef TP_DMA_REVERSE_SEGMENTS
#define TP_DMA_REVERSE_SEGMENTS 0
#endif

// Where a push lands, and what the arrival does (pallas_dma.py's PUSH and
// ARRIVAL codes).
enum Push { kPushNone = 0, kPushOut = 1, kPushSlab = 2 };
enum Arrival { kArriveNone = 0, kArriveWait = 1, kArriveCopy = 2,
               kArriveZero = 3 };

struct Header {
  unsigned long long ready[kMaxRanks];    // ready[w]: epoch w lets me push
  unsigned long long arrived[kMaxRanks];  // arrived[w]: epoch w pushed in
  unsigned long long seg[kMaxSegs];       // seg[s]: epoch whose segment s
                                          // landed in my slab
  unsigned int pushed;                    // CTAs done pushing (local)
  unsigned int pad;
  unsigned long long fault_epoch;         // newest epoch that faulted
};
static_assert(sizeof(Header) <= kHeaderBytes, "header overflows");

// Host-mapped fault record, read by the wrapper after a drain.
struct Fault {
  int phase;                 // 0 none, 1 ready wait, 2 arrival wait
  int rank;                  // this rank (global)
  int peer;                  // the rank it waited for (global)
  int pad;
  unsigned long long epoch;
};

struct Args {
  const unsigned char* x;      // what I push
  unsigned char* out;          // where my arrival lands
  unsigned char* dest;         // where my push lands (dst's output or slab)
  unsigned long long nbytes;
  unsigned long long seg_bytes;
  Header* self;   // my window
  Header* to;     // dst's window (peer-mapped, or mine)
  Header* from;   // src's window (peer-mapped, or mine)
  int me, dst, src;              // slots in the group's flag arrays
  int rank, dst_rank, src_rank;  // global ranks, for the fault record
  int push, arrive;
  int sys;                       // flags at system scope (else the card's)
  int npush;                     // CTAs [0, npush) push
  int nseg;
  unsigned long long epoch;
  unsigned long long timeout_ns;
  Fault* fault;
};

__device__ __forceinline__ unsigned char* slab(Header* h) {
  return reinterpret_cast<unsigned char*>(h) + kHeaderBytes;
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Flags and fences at the scope the launch names: the card (every peer
// is a rank of this process on the same card) or the system (peers on
// other cards, or in other processes).
__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p, bool sys) {
  unsigned long long v;
  if (sys)
    asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
                 : "=l"(v) : "l"(p) : "memory");
  else
    asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
                 : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v, bool sys) {
  if (sys)
    asm volatile("st.release.sys.global.u64 [%0], %1;"
                 :: "l"(p), "l"(v) : "memory");
  else
    asm volatile("st.release.gpu.global.u64 [%0], %1;"
                 :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void fence(bool sys) {
  if (sys)
    __threadfence_system();
  else
    __threadfence();
}

__device__ __forceinline__ unsigned long long faulted(const Args& a) {
  return *reinterpret_cast<volatile unsigned long long*>(
      &a.self->fault_epoch);
}

// Spin until *p >= epoch; false past the time bound, or once this rank
// has recorded a fault for the epoch.
__device__ bool wait_epoch(const Args& a, const unsigned long long* p) {
  const unsigned long long t0 = now_ns();
  while (ld_acquire(p, a.sys) < a.epoch) {
    if (now_ns() - t0 > a.timeout_ns || faulted(a) >= a.epoch) return false;
    __nanosleep(32);
  }
  return true;
}

// First faulting thread of this epoch writes the host record.
__device__ void report(const Args& a, int phase, int peer) {
  if (atomicMax(&a.self->fault_epoch, a.epoch) < a.epoch) {
    volatile Fault* f = a.fault;
    f->rank = a.rank;
    f->peer = peer;
    f->epoch = a.epoch;
    __threadfence_system();
    f->phase = phase;
    __threadfence_system();
  }
}

__device__ __forceinline__ int4 load16(const int4* s, unsigned long long i,
                                       bool l2) {
  if (!s) return make_int4(0, 0, 0, 0);
  return l2 ? __ldcg(s + i) : s[i];
}

// Thread t of nt copies its share of n bytes from src to dst (zeros when
// src is null): every nt-th 16-byte vector, four in flight at a time, or
// a byte loop where a pointer is not 16-byte aligned. ``l2`` reads past
// L1: a peer wrote src.
__device__ void copy_span(unsigned char* __restrict__ dst,
                          const unsigned char* __restrict__ src,
                          unsigned long long n, unsigned long long t,
                          unsigned long long nt, bool l2) {
  unsigned long long done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) |
        reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    const unsigned long long nv = n / 16;
    int4* d = reinterpret_cast<int4*>(dst);
    const int4* s = reinterpret_cast<const int4*>(src);
    unsigned long long i = t;
    for (; i + 3 * nt < nv; i += 4 * nt) {
      int4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = load16(s, i + u * nt, l2);
#pragma unroll
      for (int u = 0; u < 4; ++u) d[i + u * nt] = v[u];
    }
    for (; i < nv; i += nt) d[i] = load16(s, i, l2);
    done = nv * 16;
  }
  for (unsigned long long i = done + t; i < n; i += nt) {
    unsigned char v = 0;
    if (src) v = l2 ? __ldcg(src + i) : src[i];
    dst[i] = v;
  }
}

// Push CTA: the ready wait, then this CTA's part of the push.
__device__ void push_role(const Args& a) {
  __shared__ int aborted;
  if (threadIdx.x == 0) {
    aborted = 0;
    if (a.dst != a.me && !wait_epoch(a, &a.self->ready[a.dst])) {
      report(a, 1, a.dst_rank);
      aborted = 1;
    }
  }
  __syncthreads();
  if (a.push == kPushOut) {
    if (!aborted)
      copy_span(a.dest, a.x, a.nbytes,
                (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x,
                (unsigned long long)a.npush * blockDim.x, false);
    if (a.dst == a.me) return;  // my own output: the launch's end is the
                                // arrival
    __syncthreads();
    if (threadIdx.x == 0) {
      fence(a.sys);
      if (atomicAdd(&a.self->pushed, 1u) == (unsigned)a.npush - 1) {
        // The last CTA: every push (or abort) of this launch is done. The
        // next launch on this window starts after this kernel ends, so
        // the reset is safe.
        a.self->pushed = 0;
        fence(a.sys);
        if (faulted(a) < a.epoch)
          st_release(&a.to->arrived[a.me], a.epoch, a.sys);
      }
    }
    return;
  }
  for (int k = blockIdx.x; k < a.nseg && !aborted; k += a.npush) {
    const int s = TP_DMA_REVERSE_SEGMENTS ? a.nseg - 1 - k : k;
    const unsigned long long lo = (unsigned long long)s * a.seg_bytes;
    const unsigned long long n =
        a.nbytes - lo < a.seg_bytes ? a.nbytes - lo : a.seg_bytes;
    copy_span(a.dest + lo, a.x + lo, n, threadIdx.x, blockDim.x, false);
    __syncthreads();
    if (threadIdx.x == 0) {
      fence(a.sys);
      st_release(&a.to->seg[s], a.epoch, a.sys);
    }
  }
}

// Arrival CTA ``j`` of ``narr``: zero-fill, one thread's wait for the
// ``out`` push, or the segments j, j + narr, ... of the slab, each copied
// out once it has landed. ``kArrives``: this launch owns the wait or the
// copy (not the ship's push kernel, which leaves both to its arrival).
template <bool kArrives>
__device__ void arrival_role(const Args& a, int j, int narr) {
  if (a.arrive == kArriveZero) {
    copy_span(a.out, nullptr, a.nbytes,
              (unsigned long long)j * blockDim.x + threadIdx.x,
              (unsigned long long)narr * blockDim.x, false);
    return;
  }
  if (a.arrive == kArriveWait) {
    if (kArrives && j == 0 && threadIdx.x == 0 &&
        !wait_epoch(a, &a.self->arrived[a.src]))
      report(a, 2, a.src_rank);
    return;
  }
  if (a.arrive != kArriveCopy || !kArrives) return;
  __shared__ int landed;
  for (int s = j; s < a.nseg; s += narr) {
    if (threadIdx.x == 0) {
      landed = wait_epoch(a, &a.self->seg[s]);
      if (!landed) report(a, 2, a.src_rank);
    }
    __syncthreads();
    if (!landed) return;
    const unsigned long long lo = (unsigned long long)s * a.seg_bytes;
    const unsigned long long n =
        a.nbytes - lo < a.seg_bytes ? a.nbytes - lo : a.seg_bytes;
    copy_span(a.out + lo, slab(a.self) + lo, n, threadIdx.x, blockDim.x,
              true);
    __syncthreads();  // before thread 0 rewrites ``landed``
  }
}

// One hop: the ready store, then each CTA's role.
template <bool kArrives>
__device__ __forceinline__ void hop(const Args& a) {
  if (blockIdx.x == 0 && threadIdx.x == 0 &&
      (a.arrive == kArriveWait || a.arrive == kArriveCopy))
    st_release(&a.from->ready[a.me], a.epoch, a.sys);
  if ((int)blockIdx.x < a.npush)
    push_role(a);
  else
    arrival_role<kArrives>(a, blockIdx.x - a.npush, gridDim.x - a.npush);
}

__global__ void __launch_bounds__(kThreads) dma_permute_kernel(Args a) {
  hop<true>(a);
}

__global__ void __launch_bounds__(kThreads) dma_ship_push_kernel(Args a) {
  hop<false>(a);
}

__global__ void __launch_bounds__(kWarp) dma_ship_arrive_kernel(Args a) {
  if (threadIdx.x == 0 && !wait_epoch(a, &a.self->arrived[a.src]))
    report(a, 2, a.src_rank);
}

__global__ void __launch_bounds__(kThreads) dma_ship_copy_kernel(Args a) {
  arrival_role<true>(a, blockIdx.x, gridDim.x);
}

// kShipCopy is the grid of kShipArrive's copy form (a slab arrival).
enum Kind { kPermute = 0, kShipPush = 1, kShipCopy = 2, kShipArrive = 3 };
int g_grid[64][3];  // resident CTAs per device and grid kernel, 0 = not asked

int resident_grid(Kind kind, int* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!g_grid[dev][kind]) {
    static void (*const fns[3])(Args) = {
        dma_permute_kernel, dma_ship_push_kernel, dma_ship_copy_kernel};
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fns[kind],
                                                        kThreads, 0);
    if (err != cudaSuccess) return err;
    g_grid[dev][kind] = sms * (per_sm < 1 ? 1 : per_sm);
  }
  *grid = g_grid[dev][kind];
  return cudaSuccess;
}

unsigned long long cdiv(unsigned long long a, unsigned long long b) {
  return (a + b - 1) / b;
}

// One launch of ``kind`` on ``stream``. A hop's grid holds as many push
// and arrival CTAs as the bytes need (8 KiB a CTA for a grid-stride copy,
// one a slab segment, one for a wait), at most the resident CTAs / share,
// split between the two roles when both need more. The ship's push
// kernel leaves a wait or a copy to the arrival kernel: one warp for a
// wait, a grid of segment CTAs for a copy. Returns cudaGetLastError().
int launch(Kind kind, Args a, int share, cudaStream_t st) {
  a.seg_bytes = cdiv(cdiv(a.nbytes, kMaxSegs), 16) * 16;
  if (a.seg_bytes < kSegMin) a.seg_bytes = kSegMin;
  a.nseg = (int)cdiv(a.nbytes, a.seg_bytes);
  a.npush = 0;
  if (kind == kShipArrive && a.arrive != kArriveCopy) {
    dma_ship_arrive_kernel<<<1, kWarp, 0, st>>>(a);
    return cudaGetLastError();
  }
  if (kind == kShipArrive) kind = kShipCopy;
  int cap = 0;
  cudaError_t err = (cudaError_t)resident_grid(kind, &cap);
  if (err != cudaSuccess) return err;
  if (share > 1) cap = cap / share > 0 ? cap / share : 1;
  if (kind == kShipCopy) {
    const int grid = a.nseg < cap ? a.nseg : cap;
    dma_ship_copy_kernel<<<grid > 0 ? grid : 1, kThreads, 0, st>>>(a);
    return cudaGetLastError();
  }
  const unsigned long long per_cta = (unsigned long long)kThreads * 16;
  const unsigned long long stride_ctas = cdiv(a.nbytes, per_cta);
  unsigned long long push = a.push == kPushOut    ? stride_ctas
                            : a.push == kPushSlab ? a.nseg
                                                  : 0;
  unsigned long long arr = a.arrive == kArriveZero ? stride_ctas
                           : kind == kShipPush     ? 0
                           : a.arrive == kArriveCopy ? a.nseg
                           : a.arrive == kArriveWait ? 1
                                                     : 0;
  if (a.push != kPushNone && push == 0) push = 1;  // nbytes 0
  if (a.arrive == kArriveZero && arr == 0) arr = 1;
  const unsigned long long c = cap;
  if (push + arr > c) {
    if (push && arr) {
      const unsigned long long half = arr == 1 ? c - 1 : c / 2;
      push = push < half ? push : (half ? half : 1);
      arr = arr < c - push ? arr : (c > push ? c - push : 1);
    } else {
      push = push < c ? push : c;
      arr = arr < c ? arr : c;
    }
  }
  a.npush = (int)push;
  const int grid = push + arr > 0 ? (int)(push + arr) : 1;
  if (kind == kPermute) {
    dma_permute_kernel<<<grid, kThreads, 0, st>>>(a);
  } else {
    dma_ship_push_kernel<<<grid, kThreads, 0, st>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int tp_dma_header_bytes(void) { return (int)kHeaderBytes; }

int tp_dma_max_ranks(void) { return kMaxRanks; }

// Allocate a window of ``slab_bytes`` (plus the zeroed header) on the
// current device and export its IPC handle (64 bytes into ``handle``).
int tp_dma_window_alloc(unsigned long long slab_bytes, void** base,
                        void* handle) {
  cudaError_t err = cudaMalloc(base, kHeaderBytes + slab_bytes);
  if (err != cudaSuccess) return err;
  err = cudaMemset(*base, 0, kHeaderBytes);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err != cudaSuccess) return err;
  cudaIpcMemHandle_t h;
  err = cudaIpcGetMemHandle(&h, *base);
  if (err != cudaSuccess) return err;
  memcpy(handle, &h, sizeof(h));
  return cudaSuccess;
}

// Map a peer's window from its 64-byte handle.
int tp_dma_window_open(const void* handle, void** base) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return cudaIpcOpenMemHandle(base, h, cudaIpcMemLazyEnablePeerAccess);
}

int tp_dma_window_close(void* base) { return cudaIpcCloseMemHandle(base); }

int tp_dma_window_free(void* base) { return cudaFree(base); }

// A zeroed host-mapped fault record: its host and device addresses
// (portable: kernels on every card of the process write it).
int tp_dma_fault_alloc(void** host, void** dev) {
  cudaError_t err = cudaHostAlloc(host, sizeof(Fault),
                                  cudaHostAllocMapped | cudaHostAllocPortable);
  if (err != cudaSuccess) return err;
  memset(*host, 0, sizeof(Fault));
  return cudaHostGetDevicePointer(dev, *host, 0);
}

int tp_dma_fault_bytes(void) { return (int)sizeof(Fault); }

// Let ``dev`` read and write ``peer``'s memory (in-process ranks on two
// cards of one host). Already enabled counts as success.
int tp_dma_enable_peer(int dev, int peer) {
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return err;
  int can = 0;
  err = cudaDeviceCanAccessPeer(&can, dev, peer);
  if (err != cudaSuccess) return err;
  if (!can) return cudaErrorPeerAccessUnsupported;
  err = cudaSetDevice(dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    err = cudaSuccess;
  }
  cudaError_t back = cudaSetDevice(cur);
  return err != cudaSuccess ? err : back;
}

// The three launches share one argument list (unused pointers may be
// null): ``dest`` is where the push lands (null: no bytes), ``push`` and
// ``arrive`` the codes above, ``sys`` the scope of flags and fences (0:
// every peer is on this card in this process), ``share`` divides the
// resident grid (1 for ranks that are processes). Each returns cudaGetLastError() after the
// launch.
#define TP_DMA_ARGS                                                        \
  const void *x, void *out, void *dest, unsigned long long nbytes,        \
      void *self, void *to, void *from, int me, int dst, int src,         \
      int rank, int dst_rank, int src_rank, int push, int arrive,         \
      int sys, unsigned long long epoch, unsigned long long timeout_ns,             \
      void *fault, int share, void *stream

static int launch_kind(Kind kind, TP_DMA_ARGS) {
  Args a;
  memset(&a, 0, sizeof(a));
  a.x = static_cast<const unsigned char*>(x);
  a.out = static_cast<unsigned char*>(out);
  a.dest = static_cast<unsigned char*>(dest);
  a.nbytes = nbytes;
  a.self = static_cast<Header*>(self);
  a.to = static_cast<Header*>(to);
  a.from = static_cast<Header*>(from);
  a.me = me;
  a.dst = dst;
  a.src = src;
  a.rank = rank;
  a.dst_rank = dst_rank;
  a.src_rank = src_rank;
  a.push = dest ? push : kPushNone;
  a.arrive = arrive;
  a.sys = sys;
  a.epoch = epoch;
  a.timeout_ns = timeout_ns;
  a.fault = static_cast<Fault*>(fault);
  return launch(kind, a, share, static_cast<cudaStream_t>(stream));
}

#define TP_DMA_PASS                                                        \
  x, out, dest, nbytes, self, to, from, me, dst, src, rank, dst_rank,     \
      src_rank, push, arrive, sys, epoch, timeout_ns, fault, share, stream

// One hop of a total permutation on ``stream``.
int tp_dma_permute(TP_DMA_ARGS) { return launch_kind(kPermute, TP_DMA_PASS); }

// The push half of a fused ship (on the rank's side stream).
int tp_dma_ship_push(TP_DMA_ARGS) {
  return launch_kind(kShipPush, TP_DMA_PASS);
}

// The arrival half of a fused ship (on the rank's own stream): a wait
// (one warp) or a copy out of the slab (segment CTAs).
int tp_dma_ship_arrive(TP_DMA_ARGS) {
  return launch_kind(kShipArrive, TP_DMA_PASS);
}

}  // extern "C"
