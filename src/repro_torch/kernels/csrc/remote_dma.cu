// Remote-DMA kernels of the colls verb layer, hand-written for Hopper (sm_90a).
//
// These replace the three Pallas kernels of src/repro/kernels/remote_dma.py:
//   rdma_build_descriptors  <- build_descriptors (_build_desc_kernel)
//   rdma_gather_rows        <- gather_rows       (_gather_kernel)
//   rdma_scatter_rows       <- scatter_rows      (_scatter_kernel)
//
// Every kernel works on the port's *stacked* tensors in one launch: the grid
// covers all P participants (homes) times all lanes, where the TPU kernel ran
// once per participant under vmap.  Each kernel also counts the bytes it moves
// into a (P,) int32 counter, from the same masks that drive its copies.
//
// Bound: device-memory bytes.  At the KVStore window path's shapes a call
// moves a few KB to a few hundred KB (scatter_rows also copies the home
// buffer, see below), so in practice the host's launch work bounds it.  The
// descriptor build and the row gather are therefore built to be one device
// operation a call on exactly the arguments the verbs pass: bool masks read
// as bytes (the wrapper casts nothing), the gather's (P, N) index through
// its row stride (0 for the broadcast of one (N,) vector the read verb
// passes, so nothing is materialised), outputs and counter carved from one
// allocation, and each counter written once by the CTA (0, p) that reduces
// participant p's mask (a warp __reduce_add_sync and a shared-memory step),
// so there is no atomic and no zero fill.  The copies are the plain
// coalesced design: one thread per output word, neighbouring threads on
// neighbouring addresses.
//
// Rows are moved as 32-bit words: the wrapper passes any 4-byte dtype as its
// int32 bit pattern.  Indices must already lie in [0, slots) (the verbs clip).
// Each C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError(); the Python wrapper raises on a non-zero code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDescWords = 8;
constexpr int kDescBytes = kDescWords * 4;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kMaxChunks = 4096;

inline unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

inline unsigned int chunks_for(int64_t n) {
  int64_t c = (n + kThreads - 1) / kThreads;
  if (c < 1) c = 1;  // an empty row still launches (for the counter)
  return static_cast<unsigned int>(c < kMaxChunks ? c : kMaxChunks);
}

// The number of nonzero entries of the bool mask m[0, n), summed by the
// whole block; the result is valid in thread 0.
__device__ int block_count_nonzero(const uint8_t* __restrict__ m, int64_t n) {
  __shared__ int partial[kWarps];
  int c = 0;
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) c += m[i] != 0;
  c = __reduce_add_sync(0xffffffffu, c);
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) partial[warp] = c;
  __syncthreads();
  int total = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) total += partial[w];
  return total;
}

// count * bytes with the int32 wrap of the plain version's int32 product.
__device__ inline int32_t wrap_mul(int count, int bytes) {
  return static_cast<int32_t>(static_cast<uint32_t>(count) *
                              static_cast<uint32_t>(bytes));
}

// Grid (lane chunks, P).  Each thread writes one lane's 8-word descriptor
// [op, target, index, enabled, row_nbytes, seq, 0, 0] as two 16-byte stores;
// CTA (0, p) also counts participant p's wire lanes and stores
// nbytes[p] = DESC_BYTES per wire lane, once.
__global__ void build_desc_kernel(const int32_t* __restrict__ tgt,
                                  const int32_t* __restrict__ idx,
                                  const uint8_t* __restrict__ en,
                                  const uint8_t* __restrict__ wire,
                                  int32_t* __restrict__ desc,
                                  int32_t* __restrict__ nbytes, int R, int op,
                                  int row_nbytes) {
  const int p = blockIdx.y;
  const int64_t base = static_cast<int64_t>(p) * R;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
       lane < R; lane += stride) {
    const int64_t t = base + lane;
    int4* out = reinterpret_cast<int4*>(desc + t * kDescWords);
    out[0] = make_int4(op, tgt[t], idx[t], en[t] != 0 ? 1 : 0);
    out[1] = make_int4(row_nbytes, static_cast<int>(lane), 0, 0);
  }
  if (blockIdx.x == 0) {
    const int n = block_count_nonzero(wire + base, R);
    if (threadIdx.x == 0) nbytes[p] = wrap_mul(n, kDescBytes);
  }
}

// Grid (chunks of lanes x words, P).  Lane i of home p receives
// buf[p, idx[p * idx_stride + i]] iff mask[p, i], zeros otherwise; CTA
// (0, p) also counts home p's served lanes and stores nbytes[p] =
// row_nbytes per served lane, once.
__global__ void gather_rows_kernel(const int32_t* __restrict__ buf,
                                   const int32_t* __restrict__ idx,
                                   int64_t idx_stride,
                                   const uint8_t* __restrict__ mask,
                                   int32_t* __restrict__ out,
                                   int32_t* __restrict__ nbytes, int64_t slots,
                                   int N, int width, int row_nbytes) {
  const int p = blockIdx.y;
  const uint8_t* m = mask + static_cast<int64_t>(p) * N;
  const int32_t* ix = idx + p * idx_stride;
  const int32_t* home = buf + p * slots * width;
  int32_t* to = out + static_cast<int64_t>(p) * N * width;
  const int64_t n = static_cast<int64_t>(N) * width;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       t < n; t += stride) {
    const int64_t lane = t / width;
    const int64_t word = t - lane * width;
    int32_t v = 0;
    if (m[lane] != 0) v = home[static_cast<int64_t>(ix[lane]) * width + word];
    to[t] = v;
  }
  if (blockIdx.x == 0) {
    const int served = block_count_nonzero(m, N);
    if (threadIdx.x == 0) nbytes[p] = wrap_mul(served, row_nbytes);
  }
}

// Winner election for the lane-ordered commit.  GPU threads do not commit in
// lane order, so last-writer-wins is made explicit: every applied lane i
// raises winner[p, idx[p, i]] to i, and only the highest lane of each row
// stores (commit kernel below).  Also counts row_nbytes per wire lane.
__global__ void scatter_elect_kernel(const int32_t* __restrict__ idx,
                                     const int32_t* __restrict__ apply,
                                     const int32_t* __restrict__ wire,
                                     int32_t* __restrict__ winner,
                                     int32_t* __restrict__ nbytes,
                                     int P, int slots, int N, int row_nbytes) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<int64_t>(P) * N) return;
  const int p = static_cast<int>(t / N);
  const int lane = static_cast<int>(t - static_cast<int64_t>(p) * N);
  if (apply[t] != 0) atomicMax(winner + static_cast<int64_t>(p) * slots + idx[t], lane);
  if (wire[t] != 0) atomicAdd(nbytes + p, row_nbytes);
}

// One thread per (home, lane, word): the elected lane of each row stores its
// word into out, which the wrapper made a copy of the home buffer.
__global__ void scatter_commit_kernel(const int32_t* __restrict__ idx,
                                      const int32_t* __restrict__ apply,
                                      const int32_t* __restrict__ vals,
                                      const int32_t* __restrict__ winner,
                                      int32_t* __restrict__ out,
                                      int P, int slots, int N, int width) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<int64_t>(P) * N * width) return;
  const int64_t lane = t / width;
  if (apply[lane] == 0) return;
  const int word = static_cast<int>(t - lane * width);
  const int p = static_cast<int>(lane / N);
  const int i = static_cast<int>(lane - static_cast<int64_t>(p) * N);
  const int64_t row = static_cast<int64_t>(p) * slots + idx[lane];
  if (winner[row] == i) out[row * width + word] = vals[t];
}

}  // namespace

extern "C" {

// targets, indices: (P, R) int32; en and wire: (P, R) bool bytes.  out: one
// int32 allocation holding the (P, R, 8) descriptors, then the (P,) byte
// counter.
int rdma_build_descriptors(const void* tgt, const void* idx, const void* en,
                           const void* wire, void* out, int P, int R, int op,
                           int row_nbytes, void* stream) {
  if (P > 0) {
    int32_t* desc = static_cast<int32_t*>(out);
    const dim3 grid(chunks_for(R), static_cast<unsigned int>(P));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    build_desc_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const int32_t*>(tgt), static_cast<const int32_t*>(idx),
        static_cast<const uint8_t*>(en), static_cast<const uint8_t*>(wire),
        desc, desc + static_cast<int64_t>(P) * R * kDescWords, R, op,
        row_nbytes);
  }
  return static_cast<int>(cudaGetLastError());
}

// buf: (P, slots, width) int32 words; idx: (P, N) int32 with unit column
// stride and row stride idx_stride (0: one (N,) vector for every home);
// mask: contiguous (P, N) bool bytes.  out: one int32 allocation holding the
// (P, N, width) rows, then the (P,) byte counter.
int rdma_gather_rows(const void* buf, const void* idx, long long idx_stride,
                     const void* mask, void* out, int P, long long slots,
                     int N, int width, int row_nbytes, void* stream) {
  if (P > 0) {
    int32_t* rows = static_cast<int32_t*>(out);
    const dim3 grid(chunks_for(static_cast<int64_t>(N) * width),
                    static_cast<unsigned int>(P));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    gather_rows_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const int32_t*>(buf), static_cast<const int32_t*>(idx),
        idx_stride, static_cast<const uint8_t*>(mask), rows,
        rows + static_cast<int64_t>(P) * N * width, slots, N, width,
        row_nbytes);
  }
  return static_cast<int>(cudaGetLastError());
}

// out must hold a copy of the home buffer and winner a (P, slots) int32
// scratch filled with -1; both are the wrapper's allocations.
int rdma_scatter_rows(const void* idx, const void* apply, const void* wire,
                      const void* vals, void* winner, void* out, void* nbytes,
                      int P, int slots, int N, int width, int row_nbytes,
                      void* stream) {
  const int64_t lanes = static_cast<int64_t>(P) * N;
  if (lanes > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    scatter_elect_kernel<<<blocks_for(lanes), kThreads, 0, s>>>(
        static_cast<const int32_t*>(idx), static_cast<const int32_t*>(apply),
        static_cast<const int32_t*>(wire), static_cast<int32_t*>(winner),
        static_cast<int32_t*>(nbytes), P, slots, N, row_nbytes);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    scatter_commit_kernel<<<blocks_for(lanes * width), kThreads, 0, s>>>(
        static_cast<const int32_t*>(idx), static_cast<const int32_t*>(apply),
        static_cast<const int32_t*>(vals), static_cast<const int32_t*>(winner),
        static_cast<int32_t*>(out), P, slots, N, width);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* rdma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
