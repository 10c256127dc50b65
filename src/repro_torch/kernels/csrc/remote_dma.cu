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
// into a (P,) int32 counter, summed with atomicAdd (exact for integers), from
// the same masks that drive its copies.
//
// Bound: device-memory bytes.  At the KVStore window path's shapes a call
// moves a few KB to a few hundred KB (scatter_rows also copies the home
// buffer, see below), so in practice launch latency bounds it.  The design is
// therefore the simplest coalesced one: one thread per output word, neighbouring
// threads on neighbouring addresses.
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

inline unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

// One thread per (participant, lane): writes the lane's 8-word descriptor
// [op, target, index, enabled, row_nbytes, seq, 0, 0] as two 16-byte stores
// and adds DESC_BYTES to its participant's counter when the lane rides the wire.
__global__ void build_desc_kernel(const int32_t* __restrict__ tgt,
                                  const int32_t* __restrict__ idx,
                                  const int32_t* __restrict__ en,
                                  const int32_t* __restrict__ wire,
                                  int32_t* __restrict__ desc,
                                  int32_t* __restrict__ nbytes,
                                  int P, int R, int op, int row_nbytes) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<int64_t>(P) * R) return;
  const int p = static_cast<int>(t / R);
  const int lane = static_cast<int>(t - static_cast<int64_t>(p) * R);
  int4* out = reinterpret_cast<int4*>(desc + t * kDescWords);
  out[0] = make_int4(op, tgt[t], idx[t], en[t] != 0 ? 1 : 0);
  out[1] = make_int4(row_nbytes, lane, 0, 0);
  if (wire[t] != 0) atomicAdd(nbytes + p, kDescBytes);
}

// One thread per (home, lane, word): lane i of home p receives
// buf[p, idx[p, i]] iff mask[p, i], zeros otherwise.  The lane's word-0
// thread counts row_nbytes for a served lane.
__global__ void gather_rows_kernel(const int32_t* __restrict__ buf,
                                   const int32_t* __restrict__ idx,
                                   const int32_t* __restrict__ mask,
                                   int32_t* __restrict__ out,
                                   int32_t* __restrict__ nbytes,
                                   int P, int slots, int N, int width,
                                   int row_nbytes) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<int64_t>(P) * N * width) return;
  const int64_t lane = t / width;
  const int word = static_cast<int>(t - lane * width);
  const int p = static_cast<int>(lane / N);
  int32_t v = 0;
  if (mask[lane] != 0) {
    v = buf[(static_cast<int64_t>(p) * slots + idx[lane]) * width + word];
    if (word == 0) atomicAdd(nbytes + p, row_nbytes);
  }
  out[t] = v;
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

int rdma_build_descriptors(const void* tgt, const void* idx, const void* en,
                           const void* wire, void* desc, void* nbytes, int P,
                           int R, int op, int row_nbytes, void* stream) {
  const int64_t n = static_cast<int64_t>(P) * R;
  if (n > 0) {
    build_desc_kernel<<<blocks_for(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(tgt), static_cast<const int32_t*>(idx),
        static_cast<const int32_t*>(en), static_cast<const int32_t*>(wire),
        static_cast<int32_t*>(desc), static_cast<int32_t*>(nbytes), P, R, op,
        row_nbytes);
  }
  return static_cast<int>(cudaGetLastError());
}

int rdma_gather_rows(const void* buf, const void* idx, const void* mask,
                     void* out, void* nbytes, int P, int slots, int N,
                     int width, int row_nbytes, void* stream) {
  const int64_t n = static_cast<int64_t>(P) * N * width;
  if (n > 0) {
    gather_rows_kernel<<<blocks_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(buf), static_cast<const int32_t*>(idx),
        static_cast<const int32_t*>(mask), static_cast<int32_t*>(out),
        static_cast<int32_t*>(nbytes), P, slots, N, width, row_nbytes);
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
