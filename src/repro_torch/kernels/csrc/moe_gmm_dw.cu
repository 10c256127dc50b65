// The grouped matmul's weight gradient, hand-written for Hopper (sm_90a).
//
// Part of the backward of the grouped matmul (csrc/moe_gmm.cu), which
// replaces the Pallas kernel gmm (_gmm_kernel) of
// src/repro/kernels/moe_gmm.py; the reference has no backward kernel and
// differentiates its expert einsums (src/repro/models/moe.py expert_ffn) by
// autodiff.  For x (T, Din), dy (T, Dout), block_expert (T / block_t,) and
// optional row counts block_rows (T / block_t,):
//
//   dw[e] = sum over blocks i with block_expert[i] == e, in index order, of
//           x[i*block_t : i*block_t + n_i]^T @ dy[i*block_t : ... + n_i]
//
// with n_i = block_rows[i] clamped to [0, block_t] (block_t when there are
// no counts), summed in float32 and written once in x's type; an expert
// that no block names, or whose blocks hold no counted row, is zero.  On
// the a2a path several blocks name one expert (one per dp shard).
//
// One thread block owns one tile of one expert's (Din, Dout) gradient.  It
// finds its expert's blocks itself: the threads read block_expert and
// block_rows in chunks of the block's size, and a ballot and a prefix over
// the warps list the chunk's blocks on the expert that hold a counted row,
// in index order, in shared memory (no host read, no sort).  It then walks
// those blocks' counted rows in steps of kK rows, the product's depth, and
// never reads a row past a count; an expert with no counted row writes its
// zeros and reads nothing but the block ids.  The order of the sum is
// fixed (blocks in index order, rows in order, no atomics, no split over
// rows), so two calls are bitwise equal.
//
// Bound: device-memory bytes.  The gradient of every expert is written,
// Din x Dout each (10.7 GB a product at llama4-maverick's widths, 7.5 GB at
// deepseek-v3's), and the counted rows of x and dy are read; the tiles of
// one expert read the same rows, which stay in L2 while the expert's tiles
// run (they are adjacent in launch order).  deepseek-v3's products at a
// training batch of 2 x 4,096 tokens (top-8, 320 rows an expert) come
// within 1.4x of the card's ridge point, so bf16 runs on the tensor cores.
//
// Two kernels, chosen by the wrapper from dtype, widths and alignment:
//
// gmm_dw_mma_kernel (bfloat16, Din % 8 == 0, Dout % 8 == 0, 16-byte-aligned
// x, dy and dw): a tile of 128 x 128, 8 warps of 64 x 32.  Each step's 32
// rows of x (its 128 columns of the tile) and of dy stream through a
// kStages = 4 deep cp.async.cg ring (16-byte copies, zeros past a count or
// an edge), shared rows padded by 16 bytes; A = x^T comes from
// ldmatrix.trans of the row-major x tile, B = dy from ldmatrix.trans as in
// the forward, and mma.sync m16n8k16 accumulates in float32.  The
// epilogue rounds once to bf16, stages the tile in shared memory and
// writes it with 16-byte stores.
//
// gmm_dw_kernel (float32, which must stay exact to float32 rounding, so no
// TF32; and bf16 the 16-byte copies cannot take): the same walk on the CUDA
// cores, a tile of 32 x 256, 256 threads of 4 x 8 each, the step's x slice
// staged as float and its dy slice in its own type.
//
// block_expert values are clamped to [0, E), as in the forward.  Each C
// entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ int block_count(const int* block_rows,
                                           long long blk, int block_t) {
  return block_rows ? min(max(block_rows[blk], 0), block_t) : block_t;
}

// The blocks base .. base + kThreads - 1 on expert e that hold a counted
// row, in index order, into list (their index) and cnt (their count);
// returns how many.  Every thread of the block calls it; the block's
// earlier reads of list and cnt are over when it writes them.
template <int kThreads>
__device__ int find_blocks(const int* __restrict__ block_expert,
                           const int* __restrict__ block_rows, int nb,
                           int base, int e, int E, int block_t, int* list,
                           int* cnt, int* warp_tot) {
  __syncthreads();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = base + tid;
  int n = 0;
  if (i < nb && min(max(block_expert[i], 0), E - 1) == e)
    n = block_count(block_rows, i, block_t);
  const unsigned hits = __ballot_sync(0xffffffffu, n > 0);
  if (lane == 0) warp_tot[warp] = __popc(hits);
  __syncthreads();
  int off = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    const int t = warp_tot[w];
    off += w < warp ? t : 0;
    total += t;
  }
  if (n > 0) {
    const int j = off + __popc(hits & ((1u << lane) - 1u));
    list[j] = i;
    cnt[j] = n;
  }
  __syncthreads();
  return total;
}

// ---------------------------------------------------------------------------
// the CUDA-core kernel (float32, and bf16 the 16-byte copies cannot take)
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kTM = 4;             // gradient rows (of Din) per thread
constexpr int kTN = 8;             // gradient columns (of Dout) per thread
constexpr int kBM = 8 * kTM;       // tile rows: 8 row groups
constexpr int kBN = 32 * kTN;      // tile columns: 32 column groups
constexpr int kBK = 32;            // token rows per staged step

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// the eight values at p (16-byte aligned in shared memory) as float
__device__ __forceinline__ void load8(const float* p, float (&v)[kTN]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float (&v)[kTN]) {
  const uint4 u = reinterpret_cast<const uint4*>(p)[0];
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 -> float is a 16-bit shift
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// the eight values of v to p (16-byte aligned in device memory)
__device__ __forceinline__ void store8(float* p, const float (&v)[kTN]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(bf16* p, const float (&v)[kTN]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  reinterpret_cast<uint4*>(p)[0] = make_uint4(w[0], w[1], w[2], w[3]);
}

// rows 0 .. rows-1 of dy (from d, rows Dout apart), columns n0 .. n0+kBN-1
// into ds, zeros past the rows and the edge.  kVec: Dout is a multiple of
// the 16-byte vector and dy is 16-byte aligned.
template <typename T, bool kVec>
__device__ __forceinline__ void load_dy_tile(T (*ds)[kBN], const T* d,
                                             int rows, int n0, int Dout) {
  if constexpr (kVec) {
    constexpr int kV = 16 / sizeof(T);
    constexpr int kPerRow = kBN / kV;
    for (int v = threadIdx.x; v < kBK * kPerRow; v += kThreads) {
      const int r = v / kPerRow, c = (v % kPerRow) * kV;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r < rows && n0 + c < Dout)
        val = *reinterpret_cast<const uint4*>(
            d + static_cast<long long>(r) * Dout + n0 + c);
      *reinterpret_cast<uint4*>(&ds[r][c]) = val;
    }
  } else {
    for (int v = threadIdx.x; v < kBK * kBN; v += kThreads) {
      const int r = v / kBN, c = v % kBN;
      ds[r][c] = (r < rows && n0 + c < Dout)
                     ? d[static_cast<long long>(r) * Dout + n0 + c]
                     : T(0.f);
    }
  }
}

// grid = (ceil(Dout / kBN), ceil(Din / kBM), E)
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    gmm_dw_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                  const int* __restrict__ block_expert,
                  const int* __restrict__ block_rows, T* __restrict__ dw,
                  int E, int Din, int Dout, int block_t, int nb) {
  __shared__ float xs[kBK][kBM];
  __shared__ __align__(16) T ds[kBK][kBN];
  __shared__ int list[kThreads], cnt[kThreads], warp_tot[kThreads / 32];

  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int base = 0; base < nb; base += kThreads) {
    const int n_list = find_blocks<kThreads>(block_expert, block_rows, nb,
                                             base, e, E, block_t, list, cnt,
                                             warp_tot);
    for (int j = 0; j < n_list; ++j) {
      const long long row0 = static_cast<long long>(list[j]) * block_t;
      const int n = cnt[j];
      for (int r0 = 0; r0 < n; r0 += kBK) {
        const int rows = min(kBK, n - r0);
        const T* xb = x + (row0 + r0) * Din;
        for (int v = threadIdx.x; v < kBK * kBM; v += kThreads) {
          const int r = v / kBM, c = v % kBM;
          xs[r][c] = (r < rows && m0 + c < Din)
                         ? to_f(xb[static_cast<long long>(r) * Din + m0 + c])
                         : 0.f;
        }
        load_dy_tile<T, kVec>(ds, dy + (row0 + r0) * Dout, rows, n0, Dout);
        __syncthreads();
        for (int k = 0; k < rows; ++k) {
          float dv[kTN];
          load8(&ds[k][tx * kTN], dv);
#pragma unroll
          for (int i = 0; i < kTM; ++i) {
            const float xv = xs[k][ty * kTM + i];   // a warp-wide broadcast
#pragma unroll
            for (int jj = 0; jj < kTN; ++jj)
              acc[i][jj] = fmaf(xv, dv[jj], acc[i][jj]);
          }
        }
        __syncthreads();
      }
    }
  }

  const int col = n0 + tx * kTN;
  T* de = dw + static_cast<long long>(e) * Din * Dout;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + ty * kTM + i;
    if (m >= Din) break;
    T* o = de + static_cast<long long>(m) * Dout;
    if (kVec && col + kTN <= Dout) {
      store8(o + col, acc[i]);
    } else {
#pragma unroll
      for (int jj = 0; jj < kTN; ++jj)
        if (col + jj < Dout) from_f(o + col + jj, acc[i][jj]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* dy, const int* block_expert,
           const int* block_rows, void* dw, int T_rows, int E, int Din,
           int Dout, int block_t, cudaStream_t s) {
  const dim3 grid((Dout + kBN - 1) / kBN, (Din + kBM - 1) / kBM, E);
  const bool vec =
      Dout % (16 / static_cast<int>(sizeof(T))) == 0 &&
      reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(dw) % 16 == 0;
  const T* xt = static_cast<const T*>(x);
  const T* dt = static_cast<const T*>(dy);
  T* wt = static_cast<T*>(dw);
  if (vec)
    gmm_dw_kernel<T, true><<<grid, kThreads, 0, s>>>(
        xt, dt, block_expert, block_rows, wt, E, Din, Dout, block_t,
        T_rows / block_t);
  else
    gmm_dw_kernel<T, false><<<grid, kThreads, 0, s>>>(
        xt, dt, block_expert, block_rows, wt, E, Din, Dout, block_t,
        T_rows / block_t);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the tensor-core kernel (bfloat16)
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 256;   // 8 warps: 2 along Din x 4 along Dout
constexpr int kTileM = 128;        // gradient rows (of Din) per CTA
constexpr int kTileN = 128;        // gradient columns (of Dout) per CTA
constexpr int kK = 32;             // token rows per stage
constexpr int kStages = 4;         // cp.async ring depth
constexpr int kRS = kTileM + 8;    // shared row stride in bf16: 16 bytes of
                                   // padding, so ldmatrix is conflict-free
static_assert(kTileM == kTileN, "x and dy tiles share the row stride");
constexpr int kStage = 2 * kK * kRS;   // a stage: x rows, then dy rows
constexpr size_t kMmaSmem = sizeof(bf16) * kStages * kStage;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with valid == false the 16 bytes are zeros and
// nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16x8 float32) += a (16x16 bf16, row) . b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// grid: one CTA per (expert, 128 x 128 tile), an expert's tiles adjacent in
// launch order
__global__ void __launch_bounds__(kMmaThreads, 2)
    gmm_dw_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                      const int* __restrict__ block_expert,
                      const int* __restrict__ block_rows,
                      bf16* __restrict__ dw, int E, int Din, int Dout,
                      int block_t, int nb, int tiles_m, int tiles_n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  __shared__ int list[kMmaThreads], cnt[kMmaThreads];
  __shared__ int warp_tot[kMmaThreads / 32];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const long long tiles = static_cast<long long>(tiles_m) * tiles_n;
  const int e = static_cast<int>(blockIdx.x / tiles);
  const int t = static_cast<int>(blockIdx.x % tiles);
  const int m0 = (t / tiles_n) * kTileM, n0 = (t % tiles_n) * kTileN;

  float acc[4][4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][n][j] = 0.f;

  for (int base = 0; base < nb; base += kMmaThreads) {
    const int n_list = find_blocks<kMmaThreads>(
        block_expert, block_rows, nb, base, e, E, block_t, list, cnt,
        warp_tot);
    if (n_list == 0) continue;

    // step (j, r): rows r .. r + kK - 1 of the j-th listed block into ring
    // stage s, zeros past its count and past the tile's edges
    auto stage = [&](int j, int r, int s) {
      bf16* xs = smem + s * kStage;
      bf16* ds = xs + kK * kRS;
      const long long row0 = static_cast<long long>(list[j]) * block_t + r;
      const int rows = min(kK, cnt[j] - r);
#pragma unroll
      for (int it = 0; it < kK * (kTileM / 8) / kMmaThreads; ++it) {
        const int i = tid + it * kMmaThreads;
        const int rr = i / (kTileM / 8), c = (i % (kTileM / 8)) * 8;
        const bool okx = rr < rows && m0 + c < Din;
        cp_async16(xs + rr * kRS + c,
                   okx ? x + (row0 + rr) * Din + m0 + c : x, okx);
        const bool okd = rr < rows && n0 + c < Dout;
        cp_async16(ds + rr * kRS + c,
                   okd ? dy + (row0 + rr) * Dout + n0 + c : dy, okd);
      }
    };
    auto advance = [&](int& j, int& r) {
      r += kK;
      if (r >= cnt[j]) {
        ++j;
        r = 0;
      }
    };

    int pj = 0, pr = 0;            // the next step to stage
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (pj < n_list) {
        stage(pj, pr, s);
        advance(pj, pr);
      }
      cp_async_commit();
    }
    int cj = 0, cr = 0, slot = 0;  // the step to compute, and its stage
    while (cj < n_list) {
      cp_async_wait<kStages - 2>();  // this step has landed
      __syncthreads();               // ... for all, and the last is done
      if (pj < n_list) {
        stage(pj, pr, (slot + kStages - 1) % kStages);
        advance(pj, pr);
      }
      cp_async_commit();
      const bf16* xs = smem + slot * kStage;
      const bf16* ds = xs + kK * kRS;
#pragma unroll
      for (int kk = 0; kk < kK / 16; ++kk) {
        unsigned a[4][4];
#pragma unroll
        for (int m = 0; m < 4; ++m)  // A = x^T: the x tile is k-major
          ldsm_x4_trans(a[m], xs + (kk * 16 + (lane & 7) +
                                    (lane >> 4) * 8) * kRS +
                                  wm * 64 + m * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int dn = 0; dn < 2; ++dn) {  // column tiles 2*dn, 2*dn + 1
          unsigned b[4];
          ldsm_x4_trans(b, ds + (kk * 16 + (lane & 7) +
                                 ((lane >> 3) & 1) * 8) * kRS +
                               wn * 32 + dn * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            mma_bf16(acc[m][2 * dn], a[m], b[0], b[1]);
            mma_bf16(acc[m][2 * dn + 1], a[m], b[2], b[3]);
          }
        }
      }
      advance(cj, cr);
      slot = (slot + 1) % kStages;
    }
    cp_async_wait<0>();
    __syncthreads();               // the ring is free
  }

  // round once to bf16 into shared memory, then 16-byte stores
  __syncthreads();
  bf16* os = smem;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 64 + m * 16 + g + h * 8;
        const int c = wn * 32 + n * 8 + 2 * t4;
        *reinterpret_cast<__nv_bfloat162*>(os + r * kRS + c) =
            __floats2bfloat162_rn(acc[m][n][2 * h], acc[m][n][2 * h + 1]);
      }
  __syncthreads();
  bf16* de = dw + static_cast<long long>(e) * Din * Dout;
  for (int i = tid; i < kTileM * (kTileN / 8); i += kMmaThreads) {
    const int r = i / (kTileN / 8), c = (i % (kTileN / 8)) * 8;
    if (m0 + r < Din && n0 + c < Dout)
      *reinterpret_cast<uint4*>(
          de + static_cast<long long>(m0 + r) * Dout + n0 + c) =
          *reinterpret_cast<const uint4*>(os + r * kRS + c);
  }
}

}  // namespace

extern "C" {

const char* gmm_dw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The CUDA-core kernel.  dtype: 0 = float32, 1 = bfloat16 (x, dy and dw
// alike); block_expert int32 of T / block_t entries, block_rows the same or
// null (every row counts).  x (T, Din), dy (T, Dout), dw (E, Din, Dout),
// all contiguous.
int gmm_dw(int dtype, const void* x, const void* dy, const int* block_expert,
           const int* block_rows, void* dw, int T, int E, int Din, int Dout,
           int block_t, void* stream) {
  if (T < 0 || E < 1 || Din < 0 || Dout < 0 || block_t < 1 || T % block_t)
    return static_cast<int>(cudaErrorInvalidValue);
  if (E > 65535 || (Din + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Din == 0 || Dout == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dy, block_expert, block_rows, dw, T, E, Din,
                         Dout, block_t, s);
  if (dtype == 1)
    return launch<bf16>(x, dy, block_expert, block_rows, dw, T, E, Din, Dout,
                        block_t, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core kernel: bfloat16 x, dy and dw, Din % 8 == 0,
// Dout % 8 == 0, every pointer 16-byte aligned (the wrapper checks).
int gmm_dw_mma(const void* x, const void* dy, const int* block_expert,
               const int* block_rows, void* dw, int T, int E, int Din,
               int Dout, int block_t, void* stream) {
  if (T < 0 || E < 1 || Din < 0 || Dout < 0 || block_t < 1 ||
      T % block_t || Din % 8 || Dout % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(dy) % 16 ||
      reinterpret_cast<uintptr_t>(dw) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (Din == 0 || Dout == 0) return 0;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        gmm_dw_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kMmaSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int tiles_m = (Din + kTileM - 1) / kTileM;
  const int tiles_n = (Dout + kTileN - 1) / kTileN;
  const long long ctas = static_cast<long long>(E) * tiles_m * tiles_n;
  if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  gmm_dw_mma_kernel<<<static_cast<unsigned>(ctas), kMmaThreads, kMmaSmem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy), block_expert,
      block_rows, static_cast<bf16*>(dw), E, Din, Dout, block_t,
      T / block_t, tiles_m, tiles_n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
