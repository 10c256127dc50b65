// Remote copy of the ring-broadcast hop, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel remote_copy_tpu of
// src/repro/kernels/remote_dma.py:239 — a make_async_remote_copy send/wait
// pair that copies one buffer into the same-named buffer on a peer chip, with
// DMA send and recv semaphores that signal completion.
//
// The port binds the P participants stacked on one card, so the wire hop is a
// copy in device memory between participants' slices: row q of the (P, n)
// int32 word buffers is participant q's buffer.  Receiver q takes row
// sender[q] of src; a sender of -1, q itself or any value outside [0, P)
// means q receives nothing and keeps dst[q].  A broadcast from participant o
// is sender = o everywhere but at o.  The two (P,) byte counters stand in for
// the send and recv semaphores, counted from the same sender map that drives
// the copy: the first thread of block (0, q) writes recv[q] (the row's bytes
// if q takes a peer's row, else 0) and sent[q] (the row's bytes times the
// receivers r != q whose sender is q), reading the P-entry map.  Every
// counter is written once, so they need no zeroing and no atomics, and a
// call is one device operation.  The map is int32 or int64 (a template
// argument), as the caller holds it, so no cast runs before the copy.
//
// Bound: device-memory bytes, as there is no arithmetic: each distinct row
// read once (the senders' rows of src, and dst's rows of the receivers that
// keep their own) and all P rows written once; a broadcast reads 2 rows.
// The design is the plain coalesced copy: a grid of (chunk, receiver)
// blocks, 16 bytes per thread when n is a multiple of four words and every
// pointer is 16-byte aligned, 4-byte words otherwise, with a grid-stride
// loop over the row.  At the ring's shapes (a few KB to a few
// hundred KB per call) launch latency bounds it.
//
// The C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError(); the Python wrapper raises on a non-zero code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxChunks = 4096;

template <bool kVec, typename Idx>
__global__ void remote_copy_kernel(const int32_t* __restrict__ src,
                                   const int32_t* __restrict__ dst,
                                   const Idx* __restrict__ sender,
                                   int32_t* __restrict__ out,
                                   int32_t* __restrict__ sent,
                                   int32_t* __restrict__ recv, int P,
                                   int64_t n, int row_nbytes) {
  const int q = blockIdx.y;
  const int64_t s = sender[q];
  const bool from_peer = s >= 0 && s < P && s != q;
  const int32_t* from = from_peer ? src + s * n
                                  : dst + static_cast<int64_t>(q) * n;
  int32_t* to = out + static_cast<int64_t>(q) * n;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  if (kVec) {
    const int4* f4 = reinterpret_cast<const int4*>(from);
    int4* t4 = reinterpret_cast<int4*>(to);
    for (int64_t i = first; i < n / 4; i += stride) t4[i] = f4[i];
  } else {
    for (int64_t i = first; i < n; i += stride) to[i] = from[i];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    int receivers = 0;  // r != q with sender[r] == q (so a valid peer)
    for (int r = 0; r < P; ++r)
      receivers += r != q && static_cast<int64_t>(sender[r]) == q;
    recv[q] = from_peer ? row_nbytes : 0;
    sent[q] = receivers * row_nbytes;  // < 2^31: the wrapper's guard
  }
}

template <typename Idx>
void launch(const void* src, const void* dst, const void* sender, void* out,
            void* sent, void* recv, int P, long long n, int row_nbytes,
            int vec, dim3 grid, cudaStream_t s) {
  const int32_t* a = static_cast<const int32_t*>(src);
  const int32_t* b = static_cast<const int32_t*>(dst);
  const Idx* snd = static_cast<const Idx*>(sender);
  int32_t* o = static_cast<int32_t*>(out);
  int32_t* cs = static_cast<int32_t*>(sent);
  int32_t* cr = static_cast<int32_t*>(recv);
  if (vec)
    remote_copy_kernel<true, Idx><<<grid, kThreads, 0, s>>>(
        a, b, snd, o, cs, cr, P, n, row_nbytes);
  else
    remote_copy_kernel<false, Idx><<<grid, kThreads, 0, s>>>(
        a, b, snd, o, cs, cr, P, n, row_nbytes);
}

}  // namespace

extern "C" {

// sender: P int32 (idx64 = 0) or int64 (idx64 = 1) entries; sent and recv
// (P,) int32, each written once; vec selects the 16-byte path, which the
// wrapper takes only for n % 4 == 0 and aligned pointers.
int remote_copy(const void* src, const void* dst, const void* sender,
                int idx64, void* out, void* sent, void* recv, int P,
                long long n, int row_nbytes, int vec, void* stream) {
  if (P > 0) {
    const int64_t units = vec ? n / 4 : n;
    int64_t chunks = (units + kThreads - 1) / kThreads;
    if (chunks < 1) chunks = 1;  // n = 0 still launches (for the counters)
    if (chunks > kMaxChunks) chunks = kMaxChunks;
    const dim3 grid(static_cast<unsigned int>(chunks),
                    static_cast<unsigned int>(P));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (idx64)
      launch<int64_t>(src, dst, sender, out, sent, recv, P, n, row_nbytes,
                      vec, grid, s);
    else
      launch<int32_t>(src, dst, sender, out, sent, recv, P, n, row_nbytes,
                      vec, grid, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* remote_copy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
