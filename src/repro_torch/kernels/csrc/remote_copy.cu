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
// the send and recv semaphores: each receiver's first thread adds the row's
// bytes to its own recv counter and to its sender's send counter, from the
// same sender map that drives the copy.
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

template <bool kVec>
__global__ void remote_copy_kernel(const int32_t* __restrict__ src,
                                   const int32_t* __restrict__ dst,
                                   const int32_t* __restrict__ sender,
                                   int32_t* __restrict__ out,
                                   int32_t* __restrict__ sent,
                                   int32_t* __restrict__ recv, int P,
                                   int64_t n, int row_nbytes) {
  const int q = blockIdx.y;
  const int s = sender[q];
  const bool from_peer = s >= 0 && s < P && s != q;
  const int32_t* from = from_peer ? src + static_cast<int64_t>(s) * n
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
  if (from_peer && blockIdx.x == 0 && threadIdx.x == 0) {
    atomicAdd(recv + q, row_nbytes);
    atomicAdd(sent + s, row_nbytes);
  }
}

}  // namespace

extern "C" {

// sent and recv must be zeroed (P,) int32 counters; vec selects the 16-byte
// path, which the wrapper takes only for n % 4 == 0 and aligned pointers.
int remote_copy(const void* src, const void* dst, const void* sender,
                void* out, void* sent, void* recv, int P, long long n,
                int row_nbytes, int vec, void* stream) {
  if (P > 0) {
    const int64_t units = vec ? n / 4 : n;
    int64_t chunks = (units + kThreads - 1) / kThreads;
    if (chunks < 1) chunks = 1;  // n = 0 still launches (and copies nothing)
    if (chunks > kMaxChunks) chunks = kMaxChunks;
    const dim3 grid(static_cast<unsigned int>(chunks),
                    static_cast<unsigned int>(P));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int32_t* a = static_cast<const int32_t*>(src);
    const int32_t* b = static_cast<const int32_t*>(dst);
    const int32_t* snd = static_cast<const int32_t*>(sender);
    int32_t* o = static_cast<int32_t*>(out);
    int32_t* cs = static_cast<int32_t*>(sent);
    int32_t* cr = static_cast<int32_t*>(recv);
    if (vec) {
      remote_copy_kernel<true><<<grid, kThreads, 0, s>>>(a, b, snd, o, cs, cr,
                                                         P, n, row_nbytes);
    } else {
      remote_copy_kernel<false><<<grid, kThreads, 0, s>>>(a, b, snd, o, cs,
                                                          cr, P, n,
                                                          row_nbytes);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

const char* remote_copy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
