// Remote copy of the ring-broadcast hop between processes, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel remote_copy_tpu of
// src/repro/kernels/remote_dma.py:239 — a make_async_remote_copy send/wait
// pair that copies one buffer into the same-named buffer on a PEER chip, with
// DMA send and recv semaphores that signal completion.  remote_copy.cu is its
// counterpart for P participants stacked on one card; this one is for P
// processes, one participant a rank, on one card or on peer cards.
//
// Each rank owns two exchange windows of the hop's packed word row, one
// cudaMalloc (rcp_window_alloc), exported with cudaIpcGetMemHandle.  The
// wrapper all-gathers the handles once, and each rank maps its P - 1 peers'
// windows with cudaIpcOpenMemHandle (rcp_window_open; a process cannot open
// its own) into a device table of the P base pointers.  One hop:
//
//   1. the rank writes its packed row into its window k % 2 (rcp_stage, a
//      device-to-device copy on the caller's stream);
//   2. the wrapper all-gathers the ranks' (1,) sender views: the whole map,
//      which the byte counters need, and the fence (see remote_dma.py);
//   3. one launch of remote_copy_peers_kernel: receiver `me` pulls window
//      k % 2 of sender[me] from that rank's memory through the table.  A
//      sender of -1, of `me` itself or outside [0, P) means `me` receives
//      nothing and keeps its own row (read from `own`, its packed row).
//
// The byte counters stand in for the send and recv semaphores, counted from
// the gathered map that drives the copy, as remote_copy.cu counts them: the
// first thread of block 0 writes recv (the row's bytes if `me` takes a peer's
// row, else 0) and sent (the row's bytes times the receivers r != me whose
// sender is me).  Each is written once: no zeroing, no atomics.
//
// Bound: bytes: one row read (from the peer's window, over NVLink between
// cards or from the same device memory on one card) and one row written.  At
// the ring's shapes (a few KB to a few hundred KB) launch latency and the
// fence bound the hop.  The design is the plain coalesced copy of
// remote_copy.cu: blocks of 256 threads, 16 bytes a thread where n is a
// multiple of four words and every pointer is 16-byte aligned (the windows
// are cudaMalloc'ed and the row offsets multiples of 16 bytes), a
// grid-stride loop over the row.
//
// Every C entry point returns a cudaError_t as int; the Python wrapper
// raises on a non-zero code and never falls back to another path.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxChunks = 4096;

template <bool kVec, typename Idx>
__global__ void remote_copy_peers_kernel(const int64_t* __restrict__ bases,
                                         int64_t offset,
                                         const int32_t* __restrict__ own,
                                         const Idx* __restrict__ sender,
                                         int32_t* __restrict__ out,
                                         int32_t* __restrict__ sent,
                                         int32_t* __restrict__ recv, int P,
                                         int me, int64_t n, int row_nbytes) {
  const int64_t s = sender[me];
  const bool from_peer = s >= 0 && s < P && s != me;
  const int32_t* from =
      from_peer ? reinterpret_cast<const int32_t*>(bases[s]) + offset : own;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  if (kVec) {
    const int4* f4 = reinterpret_cast<const int4*>(from);
    int4* t4 = reinterpret_cast<int4*>(out);
    for (int64_t i = first; i < n / 4; i += stride) t4[i] = f4[i];
  } else {
    for (int64_t i = first; i < n; i += stride) out[i] = from[i];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    int receivers = 0;  // r != me with sender[r] == me (so a valid peer)
    for (int r = 0; r < P; ++r)
      receivers += r != me && static_cast<int64_t>(sender[r]) == me;
    *recv = from_peer ? row_nbytes : 0;
    *sent = receivers * row_nbytes;  // < 2^31: the wrapper's guard
  }
}

template <typename Idx>
void launch(const void* bases, long long offset, const void* own,
            const void* sender, void* out, void* sent, void* recv, int P,
            int me, long long n, int row_nbytes, int vec, dim3 grid,
            cudaStream_t s) {
  const int64_t* b = static_cast<const int64_t*>(bases);
  const int32_t* o = static_cast<const int32_t*>(own);
  const Idx* snd = static_cast<const Idx*>(sender);
  int32_t* dst = static_cast<int32_t*>(out);
  int32_t* cs = static_cast<int32_t*>(sent);
  int32_t* cr = static_cast<int32_t*>(recv);
  if (vec)
    remote_copy_peers_kernel<true, Idx><<<grid, kThreads, 0, s>>>(
        b, offset, o, snd, dst, cs, cr, P, me, n, row_nbytes);
  else
    remote_copy_peers_kernel<false, Idx><<<grid, kThreads, 0, s>>>(
        b, offset, o, snd, dst, cs, cr, P, me, n, row_nbytes);
}

}  // namespace

extern "C" {

// A rank's exchange windows: `nbytes` of device memory from cudaMalloc
// (never a piece of a caching allocator's segment), its address in *ptr and
// its IPC handle's cudaIpcMemHandle_t bytes in handle[0..63].
int rcp_window_alloc(long long nbytes, void** ptr, void* handle) {
  cudaError_t e = cudaMalloc(ptr, static_cast<size_t>(nbytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaIpcMemHandle_t h;
  e = cudaIpcGetMemHandle(&h, *ptr);
  if (e != cudaSuccess) {
    cudaFree(*ptr);
    *ptr = nullptr;
    return static_cast<int>(e);
  }
  memcpy(handle, &h, sizeof(h));
  return 0;
}

int rcp_window_free(void* ptr) { return static_cast<int>(cudaFree(ptr)); }

// A peer's windows mapped into this process from their handle's bytes.
int rcp_window_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return static_cast<int>(
      cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

int rcp_window_close(void* ptr) {
  return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}

// Step 1 of a hop: this rank's packed row into its window, on the stream.
int rcp_stage(void* window, const void* row, long long nbytes, void* stream) {
  return static_cast<int>(cudaMemcpyAsync(
      window, row, static_cast<size_t>(nbytes), cudaMemcpyDeviceToDevice,
      static_cast<cudaStream_t>(stream)));
}

// Step 3: bases, P int64 window addresses (this rank's own entry unused);
// offset, the window's first word; own, this rank's packed row; sender, the
// gathered map, P int32 (idx64 = 0) or int64 (idx64 = 1) entries; out (n,),
// sent (1,) and recv (1,) int32, each written once.
int remote_copy_peers(const void* bases, long long offset, const void* own,
                      const void* sender, int idx64, void* out, void* sent,
                      void* recv, int P, int me, long long n, int row_nbytes,
                      int vec, void* stream) {
  const int64_t units = vec ? n / 4 : n;
  int64_t chunks = (units + kThreads - 1) / kThreads;
  if (chunks < 1) chunks = 1;  // n = 0 still launches (for the counters)
  if (chunks > kMaxChunks) chunks = kMaxChunks;
  const dim3 grid(static_cast<unsigned int>(chunks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx64)
    launch<int64_t>(bases, offset, own, sender, out, sent, recv, P, me, n,
                    row_nbytes, vec, grid, s);
  else
    launch<int32_t>(bases, offset, own, sender, out, sent, recv, P, me, n,
                    row_nbytes, vec, grid, s);
  return static_cast<int>(cudaGetLastError());
}

const char* remote_copy_peers_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
