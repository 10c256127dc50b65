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
// Bound: device-memory bytes.  At the KVStore window path's shapes the
// descriptor build and the row gather move a few KB to a few hundred KB, so
// in practice the host's launch work bounds them; scatter_rows returns a new
// home buffer, so one read and one write of it (168 MB at P = 8, 2^22 / 8 + 4
// slots of 5 words) bound it.  All three are one device operation a call on
// exactly the arguments the verbs pass: bool masks read as bytes (the
// wrapper casts nothing), a (P, N) index through its row stride (0 for the
// broadcast of one (N,) vector the read and write verbs pass, so nothing is
// materialised), outputs and counter carved from one allocation, and each
// counter written once by the CTA (0, p) that reduces participant p's mask
// (a warp __reduce_add_sync and a shared-memory step), so there is no
// atomic in device memory and no zero fill.  The descriptor build and the
// gather are the plain coalesced design: one thread per output word,
// neighbouring threads on neighbouring addresses.  scatter_rows elects each
// row's last writer inside the copy of the buffer (see its kernel).
//
// Rows are moved as 32-bit words: the wrapper passes any 4-byte dtype as its
// int32 bit pattern.  Gather indices must already lie in [0, slots) (the
// verbs clip); a scatter index in [-slots, 0) wraps, and one outside
// [-slots, slots) is not committed.
// Each C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError(); the Python wrapper raises on a non-zero code.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kDescWords = 8;
constexpr int kDescBytes = kDescWords * 4;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kMaxChunks = 4096;
// Rows a scatter CTA owns: ~64 Ki words (256 KB) of the buffer, at most
// 8,192 rows (its winner table is then 32 KB of shared memory).
constexpr int kStripeWords = 65536;
constexpr int kStripeRows = 8192;

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

// The lane-ordered commit, fused with the copy that keeps the call
// functional: grid (stripes of rows, P).  CTA (x, p) owns rows [r0, r1) of
// home p and a shared-memory winner table for them.  It scans home p's N
// lanes (the index through its row stride, 0 for the write verb's broadcast;
// the apply mask as bytes) and raises win[row - r0] to the lane id of every
// applied lane whose row falls in the stripe (a shared atomicMax, so the
// last lane in lane order wins, as the TPU kernel's sequential loop makes
// it).  Then it streams the stripe's words from buf to out, 16 bytes a
// thread where buf and out share their alignment (vec), taking each word of
// an elected row from values in place of buf.  Every output word is written
// once, by the one CTA that owns it: no global atomics, no order between
// CTAs, no winner array in device memory.  An index in [-slots, 0) wraps
// to the end of the buffer; any other index outside [0, slots) falls in no
// stripe and is never written.  CTA (0, p) also
// counts home p's wire lanes and stores nbytes[p] = row_nbytes per wire
// lane, once.
__global__ void __launch_bounds__(kThreads)
    scatter_rows_kernel(const int32_t* __restrict__ buf,
                        const int32_t* __restrict__ idx, int64_t idx_stride,
                        const uint8_t* __restrict__ apply,
                        const uint8_t* __restrict__ wire,
                        const int32_t* __restrict__ vals,
                        int32_t* __restrict__ out,
                        int32_t* __restrict__ nbytes, int64_t slots, int N,
                        int width, int row_nbytes, int stripe_rows, int vec) {
  __shared__ int win[kStripeRows];
  const int p = blockIdx.y;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * stripe_rows;
  const int64_t r1 = min(r0 + stripe_rows, slots);
  const int rows = static_cast<int>(r1 - r0);
  for (int i = threadIdx.x; i < rows; i += kThreads) win[i] = -1;
  __syncthreads();
  const int32_t* ix = idx + p * idx_stride;
  const uint8_t* ap = apply + static_cast<int64_t>(p) * N;
  for (int lane = threadIdx.x; lane < N; lane += kThreads) {
    int64_t r = ix[lane];
    if (r < 0) r += slots;  // [-slots, 0) wraps; the rest falls outside
    const int64_t row = r - r0;
    if (ap[lane] != 0 && row >= 0 && row < rows) atomicMax(win + row, lane);
  }
  __syncthreads();
  if (blockIdx.x == 0) {
    const int n = block_count_nonzero(wire + static_cast<int64_t>(p) * N, N);
    if (threadIdx.x == 0) nbytes[p] = wrap_mul(n, row_nbytes);
  }

  const int64_t home = static_cast<int64_t>(p) * slots * width;
  const int32_t* src = buf + home;
  int32_t* dst = out + home;
  const int32_t* val = vals + static_cast<int64_t>(p) * N * width;
  const int64_t w0 = r0 * width, w1 = r1 * width;
  // out[home + w] for one word w of the stripe
  auto word = [&](int64_t w) {
    const int64_t row = w / width;
    const int lane = win[row - r0];
    dst[w] = lane < 0 ? src[w]
                      : val[static_cast<int64_t>(lane) * width + w - row * width];
  };
  // words before the first 16-byte boundary and after the last, one by one
  int64_t v0 = w1, v1 = w1;
  if (vec) {
    const int64_t mis = (reinterpret_cast<uintptr_t>(dst + w0) >> 2) & 3;
    v0 = min(w1, w0 + ((4 - mis) & 3));
    v1 = v0 + ((w1 - v0) & ~int64_t{3});
  }
  for (int64_t w = w0 + threadIdx.x; w < v0; w += kThreads) word(w);
  for (int64_t w = v1 + threadIdx.x; w < w1; w += kThreads) word(w);
  // the 16-byte body: thread t takes vectors t, t + kThreads, ...; its
  // first word's row and column are found once and stepped after that
  constexpr int kStep = 4 * kThreads;
  int64_t w = v0 + 4 * threadIdx.x;
  if (w >= v1) return;
  int64_t row = w / width;
  int col = static_cast<int>(w - row * width);
  const int64_t step_rows = kStep / width;
  const int step_cols = kStep - static_cast<int>(step_rows) * width;
  for (; w < v1; w += kStep) {
    int4 x = *reinterpret_cast<const int4*>(src + w);
    int v[4] = {x.x, x.y, x.z, x.w};
    int64_t r = row;
    int c = col;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int lane = win[r - r0];
      if (lane >= 0) v[j] = val[static_cast<int64_t>(lane) * width + c];
      if (++c == width) {
        c = 0;
        ++r;
      }
    }
    *reinterpret_cast<int4*>(dst + w) = make_int4(v[0], v[1], v[2], v[3]);
    row += step_rows;
    col += step_cols;
    if (col >= width) {
      col -= width;
      ++row;
    }
  }
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

// buf: (P, slots, width) int32 words; idx: (P, N) int32 with unit column
// stride and row stride idx_stride (0: one (N,) vector for every home);
// apply and wire: contiguous (P, N) bool bytes; vals: (P, N, width) int32
// words.  out: one int32 allocation holding the (P, slots, width) new
// buffer, then the (P,) byte counter.
int rdma_scatter_rows(const void* buf, const void* idx, long long idx_stride,
                      const void* apply, const void* wire, const void* vals,
                      void* out, int P, long long slots, int N, int width,
                      int row_nbytes, void* stream) {
  if (width < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int stripe_rows = std::max(1, std::min(kStripeWords / width,
                                               kStripeRows));
  // 16-byte copies where buf and out share their alignment
  const int vec = (reinterpret_cast<uintptr_t>(buf) |
                   reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  if (P > 0) {
    int32_t* o = static_cast<int32_t*>(out);
    int64_t stripes = (slots + stripe_rows - 1) / stripe_rows;
    if (stripes < 1) stripes = 1;  // CTA (0, p) still writes the counter
    const dim3 grid(static_cast<unsigned int>(stripes),
                    static_cast<unsigned int>(P));
    scatter_rows_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(buf), static_cast<const int32_t*>(idx),
        idx_stride, static_cast<const uint8_t*>(apply),
        static_cast<const uint8_t*>(wire), static_cast<const int32_t*>(vals),
        o, o + static_cast<int64_t>(P) * slots * width, slots, N, width,
        row_nbytes, stripe_rows, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* rdma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
