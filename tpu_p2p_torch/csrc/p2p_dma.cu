// Peer-push permute for the ``pallas_dma`` transport, on CUDA IPC windows.
//
// Replaces tpu_p2p/parallel/pallas_dma.py::_dma_transport_permute_call
// (kernel body ``dma_transport_ppermute``, :166): one hop of a total
// permutation. Each rank pushes its whole buffer into its destination's
// receive slab, waits for its own arrival, and copies the arrival out
// (or writes zeros where the arrival is a dummy edge of the completed
// permutation).
//
// The symmetric window. Every rank of a group allocates one window per
// capacity with cudaMalloc (not from PyTorch's caching allocator, whose
// IPC handle would name the block's base): a 4 KiB header of flags, then
// the receive slab. The Python side exchanges the cudaIpcMemHandle_t of
// each window over the host group and opens the peers' windows with
// cudaIpcOpenMemHandle; that works between processes on one card and
// between the cards of one host. A rank's own window is its own pointer
// (a process cannot open its own handle), so a self-edge is a local copy
// through the same code.
//
// The handshake, with epochs instead of resets. Each launch on a window
// carries the next value ``e`` of the window's counter, the same on every
// rank, so no flag is ever cleared:
//   ready    I store e into my source's ready[me] ("push into my slab"),
//            then wait until my own ready[dst] reads >= e;
//   push     every CTA copies its share into dst's slab in 16-byte
//            vectors (a byte loop for the ragged tail or a misaligned
//            buffer), then __threadfence_system();
//   arrival  the last CTA to finish pushing (a counter in my own header)
//            stores e into dst's arrived[me] with release semantics at
//            system scope; every CTA polls my arrived[src] with acquire
//            loads until it reads >= e;
//   out      every CTA copies its share of my slab to ``out`` (or zeros).
// One flag slot per writer keeps epochs of different permutations apart:
// only dst writes my ready[dst] and only src my arrived[src]. A receiver
// says "ready for e" only after its launch e-1 has copied out (stream
// order), so back-to-back launches never overwrite an unread arrival.
//
// No hang: every spin is bounded by %globaltimer. Past the bound the
// kernel records the phase, the peer and the epoch in a host-mapped word
// and returns; the wrapper raises TransferTimeout from it.
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
//   dma_ship_push_kernel    (side stream) the ready handshake and the
//                           push; the last CTA releases dst's arrived[me];
//   dma_ship_arrive_kernel  (the rank's own stream, after the compute was
//                           issued there) waits on arrived[src], copies
//                           the slab out (or zeros).
// The caller orders the side stream after everything its own stream
// issued before (the ship's producer and the previous arrival), so
// "ready for e" still follows the copy-out of e-1, and joins the side
// stream back after the arrival. Both launches reuse the permute
// kernel's two halves below, so flags, epochs and faults are the same.
//
// In-process ranks (a LocalMesh: one process drives several ranks, each
// with its own streams, possibly on one card) run their kernels
// concurrently, not time-sliced as processes are. A spinning grid that
// filled the card would keep a peer's kernel from ever starting, so the
// caller passes ``share``: the grid is at most resident / share CTAs
// (share = 2 x the ranks on the card: every rank's push and arrival fit
// at once with room to spare for the compute).
//
// What bounds it: bytes. The function moves the buffer once (read x,
// write the peer's copy: 2 x nbytes over device memory on one card, or
// nbytes over NVLink between cards). This first version stages through
// the slab, so it reads and writes each byte twice; pushing straight into
// a window-resident output would halve that and is later work.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxRanks = 64;
constexpr size_t kHeaderBytes = 4096;

struct Header {
  unsigned long long ready[kMaxRanks];    // ready[w]: epoch w lets me push
  unsigned long long arrived[kMaxRanks];  // arrived[w]: epoch w pushed in
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
  const unsigned char* x;
  unsigned char* out;
  unsigned long long nbytes;
  Header* self;   // my window
  Header* to;     // dst's window (peer-mapped, or mine)
  Header* from;   // src's window (peer-mapped, or mine)
  int me, dst, src;            // slots in the group's flag arrays
  int rank, dst_rank, src_rank;  // global ranks, for the fault record
  int has_in;
  int vec16;                   // x, out and slabs all 16-byte aligned
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

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// Spin until *p >= e; false past the time bound.
__device__ bool wait_epoch(const unsigned long long* p, unsigned long long e,
                           unsigned long long timeout_ns) {
  const unsigned long long t0 = now_ns();
  while (ld_acquire(p) < e) {
    if (now_ns() - t0 > timeout_ns) return false;
    __nanosleep(64);
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

// Grid-stride copy of this CTA's share; zeros when src is null.
__device__ void copy_share(unsigned char* dst, const unsigned char* src,
                           unsigned long long n, bool vec16, bool cached) {
  const unsigned long long tid =
      (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  unsigned long long done = 0;
  if (vec16) {
    const unsigned long long nv = n / 16;
    int4* d4 = reinterpret_cast<int4*>(dst);
    const int4* s4 = reinterpret_cast<const int4*>(src);
    for (unsigned long long i = tid; i < nv; i += stride) {
      int4 v = make_int4(0, 0, 0, 0);
      if (s4) v = cached ? s4[i] : __ldcg(s4 + i);
      d4[i] = v;
    }
    done = nv * 16;
  }
  for (unsigned long long i = done + tid; i < n; i += stride) {
    unsigned char v = 0;
    if (src) v = cached ? src[i] : __ldcg(src + i);
    dst[i] = v;
  }
}

// First half of a hop: the ready handshake, this CTA's share of the
// push, and (last CTA) the release of dst's arrived[me]. → whether this
// CTA gave up waiting (the same value in every thread of the CTA).
__device__ bool push_half(const Args& a) {
  __shared__ int aborted;
  if (threadIdx.x == 0) {
    aborted = 0;
    if (blockIdx.x == 0) st_release(&a.from->ready[a.me], a.epoch);
    if (!wait_epoch(&a.self->ready[a.dst], a.epoch, a.timeout_ns)) {
      report(a, 1, a.dst_rank);
      aborted = 1;
    }
  }
  __syncthreads();
  if (!aborted) copy_share(slab(a.to), a.x, a.nbytes, a.vec16, true);
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int before = atomicAdd(&a.self->pushed, 1u);
    if (before == gridDim.x - 1) {
      // The last CTA: every push (or abort) of this launch is done. The
      // next launch starts after this kernel ends, so the reset is safe.
      a.self->pushed = 0;
      const unsigned long long faulted =
          *reinterpret_cast<volatile unsigned long long*>(
              &a.self->fault_epoch);
      if (faulted < a.epoch) st_release(&a.to->arrived[a.me], a.epoch);
    }
  }
  const bool out = aborted != 0;
  __syncthreads();
  return out;
}

// Second half: wait for src's push into my slab, then copy it out (or
// zeros for a dummy arrival). Skipped when the first half gave up.
__device__ void arrive_half(const Args& a, bool aborted) {
  __shared__ int failed;
  if (threadIdx.x == 0) {
    failed = aborted ? 1 : 0;
    if (!aborted &&
        !wait_epoch(&a.self->arrived[a.src], a.epoch, a.timeout_ns)) {
      report(a, 2, a.src_rank);
      failed = 1;
    }
  }
  __syncthreads();
  if (failed) return;
  copy_share(a.out, a.has_in ? slab(a.self) : nullptr, a.nbytes, a.vec16,
             false);
}

__global__ void __launch_bounds__(kThreads) dma_permute_kernel(Args a) {
  arrive_half(a, push_half(a));
}

__global__ void __launch_bounds__(kThreads) dma_ship_push_kernel(Args a) {
  push_half(a);
}

__global__ void __launch_bounds__(kThreads) dma_ship_arrive_kernel(Args a) {
  arrive_half(a, false);
}

enum Kind { kPermute = 0, kPush = 1, kArrive = 2 };
int g_grid[64][3];  // resident CTAs per device and kernel, 0 = not asked

int resident_grid(Kind kind, int* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!g_grid[dev][kind]) {
    static void (*const fns[3])(Args) = {
        dma_permute_kernel, dma_ship_push_kernel, dma_ship_arrive_kernel};
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

// One launch of ``kind`` on ``stream``: the grid is what the bytes need,
// at most the resident CTAs / share. Returns cudaGetLastError().
int launch(Kind kind, const void* x, void* out, unsigned long long nbytes,
           void* self, void* to, void* from, int me, int dst, int src,
           int rank, int dst_rank, int src_rank, int has_in, int vec16,
           unsigned long long epoch, unsigned long long timeout_ns,
           void* fault, int share, void* stream) {
  int grid = 0;
  cudaError_t err = (cudaError_t)resident_grid(kind, &grid);
  if (err != cudaSuccess) return err;
  if (share > 1) grid = grid / share > 0 ? grid / share : 1;
  const unsigned long long per_cta = (unsigned long long)kThreads * 16;
  const unsigned long long need = (nbytes + per_cta - 1) / per_cta;
  if (need < (unsigned long long)grid) grid = need ? (int)need : 1;
  Args a;
  a.x = static_cast<const unsigned char*>(x);
  a.out = static_cast<unsigned char*>(out);
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
  a.has_in = has_in;
  a.vec16 = vec16;
  a.epoch = epoch;
  a.timeout_ns = timeout_ns;
  a.fault = static_cast<Fault*>(fault);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == kPermute) {
    dma_permute_kernel<<<grid, kThreads, 0, st>>>(a);
  } else if (kind == kPush) {
    dma_ship_push_kernel<<<grid, kThreads, 0, st>>>(a);
  } else {
    dma_ship_arrive_kernel<<<grid, kThreads, 0, st>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int tp_dma_header_bytes(void) { return (int)kHeaderBytes; }

int tp_dma_max_ranks(void) { return kMaxRanks; }

// Allocate a zeroed window of ``slab_bytes`` (plus the header) on the
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
// null): ``share`` divides the resident grid, 1 for ranks that are
// processes. Each returns cudaGetLastError() after the launch.
#define TP_DMA_ARGS                                                        \
  const void *x, void *out, unsigned long long nbytes, void *self,        \
      void *to, void *from, int me, int dst, int src, int rank,           \
      int dst_rank, int src_rank, int has_in, int vec16,                   \
      unsigned long long epoch, unsigned long long timeout_ns,             \
      void *fault, int share, void *stream
#define TP_DMA_PASS                                                        \
  x, out, nbytes, self, to, from, me, dst, src, rank, dst_rank, src_rank,  \
      has_in, vec16, epoch, timeout_ns, fault, share, stream

// One hop of a total permutation on ``stream``.
int tp_dma_permute(TP_DMA_ARGS) { return launch(kPermute, TP_DMA_PASS); }

// The push half of a fused ship (on the rank's side stream).
int tp_dma_ship_push(TP_DMA_ARGS) { return launch(kPush, TP_DMA_PASS); }

// The arrival half of a fused ship (on the rank's own stream).
int tp_dma_ship_arrive(TP_DMA_ARGS) { return launch(kArrive, TP_DMA_PASS); }

}  // extern "C"
