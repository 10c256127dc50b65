// Grouped matmul (MoE expert FFN), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel gmm (_gmm_kernel) of
// src/repro/kernels/moe_gmm.py.  For x (T, Din), w (E, Din, Dout),
// block_expert (T / block_t,) and optional row counts block_rows
// (T / block_t,):
//
//   out[i*block_t + r] = x[i*block_t + r] @ w[block_expert[i]]   r < n_i
//   out[i*block_t + r] = 0                                       otherwise
//
// with n_i = block_rows[i] clamped to [0, block_t] (block_t when there are
// no counts), accumulated in float32 and written once in x's type, for any
// block_t >= 1 that divides T and any Din and Dout: ragged tiles are masked
// here, nothing is padded in memory.  The TPU kernel takes block_expert by
// scalar prefetch into its weight BlockSpec and reduces over Din on its
// sequential minor grid axis with a VMEM accumulator; here each thread
// block reads its own expert id and row count and loops over Din itself,
// with the sum in registers, so nothing carries between thread blocks and
// the sum's order is fixed (no atomics, no split over Din).
//
// Bound: device-memory bytes.  On the MoE path block i holds expert i's
// slots (block_expert = arange(E)) and n_i is the number of tokens the
// expert kept, so a call must read the weights of the experts that hold a
// token, once.  At llama4-maverick's widths a prefill (every expert live,
// 24 rows a block) reads all 10.7 GB of a product against 0.26 TFLOP, an
// intensity of ~24 FLOP/byte, far under the card's ridge point: 3.23 ms at
// 3.35 TB/s.  A decode step (4 tokens, top-1) has at most 4 live blocks of
// one row: 4 x 84 MB of weights, ~0.1 ms.  A block whose count is 0 writes
// its zero rows and never touches w, so an empty expert costs no weight
// bytes; rows past a count are written as zeros.
//
// Two kernels, chosen by the wrapper from dtype, widths and alignment:
//
// gmm_mma_kernel (bfloat16, Din % 8 == 0, Dout % 8 == 0, 16-byte-aligned
// x, w and out): the products on the tensor cores.  One CTA of 4 warps owns
// the rows of one block, in chunks of kMT m16 tiles (block_t 8 -> 16 rows,
// 24 -> 32, zero rows in shared memory), and kBN = 128 output columns, 32 a
// warp.  It loops over Din in kBK = 64 steps; the 64 x 128 weight tile
// (16 KB) and the chunk's x slice stream through a kStages = 4 deep
// cp.async.cg ring (16-byte copies, L1 bypassed), so three tiles are in
// flight while one computes: with two CTAs an SM that is ~13 MB in flight
// on the card, well above its bandwidth-delay product.  Shared rows are
// padded by 16 bytes, so every ldmatrix phase hits 8 distinct bank groups.
// A fragments come from ldmatrix of x, B fragments from ldmatrix.trans of
// the k-major weight tile, and mma.sync m16n8k16 (bf16 in, float32
// accumulate) runs only on the m16 tiles that hold a counted row
// (ceil(n / 16) of them).  The epilogue rounds to bf16 once, stages the tile
// in shared memory and writes it with 16-byte stores.  The tensor cores are
// not the limit: a prefill product at the bytes bound needs ~80 TFLOP/s, so
// mma.sync suffices and wgmma is not needed.  CTAs walk the columns of one
// block before the next block, so a block's x rows stay in L2.
//
// gmm_kernel (float32, which must stay exact to float32 rounding, so no
// TF32; and bf16 whose widths or pointers the 16-byte copies cannot take):
// the products on the CUDA cores.  grid = (T / block_t, ceil(Dout / kBN)),
// 256 threads; a block loops over its counted rows in chunks of at most
// kMR = 32 and, for each, over Din in steps of kBK = 32: it stages the
// kBK x kBN tile of w[expert] (native type) and the rows x kBK slice of x
// (as float) in shared memory, then thread (tx, ty) adds the products of
// rows ty*4 .. ty*4+3 and columns tx*8 .. tx*8+7 into 32 float registers;
// warps whose rows all lie past the count skip the arithmetic.
//
// The CUDA-core kernel's transposed instance (kTrans, entry gmm_dx) is the
// input gradient of the same function on float32 and on bf16 the 16-byte
// copies cannot take, dx = dy @ w[e]^T, for the autograd Function
// GroupedMatmul: the weight tile read along the other dimension, w[e] (N,
// K) row-major in memory for the product's depth K and width N, so that
// the forward's w (E, Din, Dout) serves as it is (no transposed copy: 10.7
// GB a leaf at llama4-maverick's widths), coalesced along k and stored
// k-major into a padded shared tile (4-way bank conflicts instead of
// 32-way).  The bf16 tensor-core input gradient is csrc/moe_gmm_dx.cu's.
//
// block_expert values are clamped to [0, E) so that no read leaves w.  Each
// C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int block_count(const int* block_rows,
                                           long long blk, int block_t) {
  return block_rows ? min(max(block_rows[blk], 0), block_t) : block_t;
}

// ---------------------------------------------------------------------------
// the CUDA-core kernel (float32, and bf16 the 16-byte copies cannot take)
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kTM = 4;             // rows per thread
constexpr int kTN = 8;             // columns per thread
constexpr int kMR = 8 * kTM;       // rows per chunk: 8 row groups
constexpr int kBN = 32 * kTN;      // columns per block: 32 column groups
constexpr int kBK = 32;            // depth per staged tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// the eight values at p (16-byte aligned in shared memory) as float
__device__ __forceinline__ void load8(const float* p, float (&v)[kTN]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&v)[kTN]) {
  const uint4 u = reinterpret_cast<const uint4*>(p)[0];
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 -> float is a 16-bit shift
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// the eight values of acc to p (16-byte aligned in device memory)
__device__ __forceinline__ void store8(float* p, const float (&v)[kTN]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&v)[kTN]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  reinterpret_cast<uint4*>(p)[0] = make_uint4(w[0], w[1], w[2], w[3]);
}

// w[k0 : k0+kBK, n0 : n0+kBN] of one expert into ws, zeros past the edges.
// kVec: Dout is a multiple of the 16-byte vector and w is 16-byte aligned,
// so a vector lies wholly inside or wholly outside the matrix.  kTrans: the
// expert's matrix is (Dout, Din) row-major in memory (element (k, n) at
// n * Din + k), read along k so that a warp's loads are contiguous.
template <typename T, bool kVec, bool kTrans, int kS>
__device__ __forceinline__ void load_w_tile(T (*ws)[kS], const T* w, int k0,
                                            int n0, int Din, int Dout) {
  if constexpr (kTrans) {
    for (int v = threadIdx.x; v < kBK * kBN; v += kThreads) {
      const int r = v % kBK, c = v / kBK;
      const int k = k0 + r, n = n0 + c;
      ws[r][c] = (k < Din && n < Dout)
                     ? w[static_cast<long long>(n) * Din + k]
                     : T(0.f);
    }
  } else if constexpr (kVec) {
    constexpr int kV = 16 / sizeof(T);        // elements per vector
    constexpr int kPerRow = kBN / kV;
    for (int v = threadIdx.x; v < kBK * kPerRow; v += kThreads) {
      const int r = v / kPerRow, c = (v % kPerRow) * kV;
      const int k = k0 + r, n = n0 + c;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (k < Din && n < Dout)
        val = *reinterpret_cast<const uint4*>(
            w + static_cast<long long>(k) * Dout + n);
      *reinterpret_cast<uint4*>(&ws[r][c]) = val;
    }
  } else {
    for (int v = threadIdx.x; v < kBK * kBN; v += kThreads) {
      const int r = v / kBN, c = v % kBN;
      const int k = k0 + r, n = n0 + c;
      ws[r][c] = (k < Din && n < Dout)
                     ? w[static_cast<long long>(k) * Dout + n]
                     : T(0.f);
    }
  }
}

// kTrans pads the weight tile's rows by 16 bytes (its stores run down
// columns); the row stride stays a multiple of 16 bytes for load8
template <typename T, bool kVec, bool kTrans>
__global__ void __launch_bounds__(kThreads)
    gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const int* __restrict__ block_expert,
               const int* __restrict__ block_rows, T* __restrict__ out,
               int E, int Din, int Dout, int block_t) {
  constexpr int kS = kBN + (kTrans ? 16 / static_cast<int>(sizeof(T)) : 0);
  __shared__ __align__(16) T ws[kBK][kS];
  __shared__ float xs[kMR][kBK];

  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const long long blk = blockIdx.x;
  const int live = block_count(block_rows, blk, block_t);
  const int e = min(max(block_expert[blk], 0), E - 1);
  const T* we = w + static_cast<long long>(e) * Din * Dout;
  const int n0 = blockIdx.y * kBN;
  const int col = n0 + tx * kTN;

  for (int r0 = 0; r0 < block_t; r0 += kMR) {
    const int rows = min(kMR, block_t - r0);
    const int lrows = max(0, min(rows, live - r0));  // counted rows
    const T* xb = x + (blk * block_t + r0) * static_cast<long long>(Din);
    const bool active = ty * kTM < lrows;     // the same for a whole warp
    float acc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

    // a chunk wholly past the count reads no weights (block-uniform)
    for (int k0 = 0; lrows > 0 && k0 < Din; k0 += kBK) {
      load_w_tile<T, kVec, kTrans, kS>(ws, we, k0, n0, Din, Dout);
      for (int v = threadIdx.x; v < kMR * kBK; v += kThreads) {
        const int r = v / kBK, k = v % kBK;
        xs[r][k] = (r < lrows && k0 + k < Din)
                       ? to_f(xb[static_cast<long long>(r) * Din + k0 + k])
                       : 0.f;
      }
      __syncthreads();
      if (active) {
#pragma unroll 8
        for (int k = 0; k < kBK; ++k) {
          float wv[kTN];
          load8(&ws[k][tx * kTN], wv);
#pragma unroll
          for (int i = 0; i < kTM; ++i) {
            const float xv = xs[ty * kTM + i][k];   // a warp-wide broadcast
#pragma unroll
            for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(xv, wv[j],
                                                          acc[i][j]);
          }
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int r = ty * kTM + i;
      if (r >= rows) break;
      if (r >= lrows) {            // past the count: zeros
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
      }
      T* o = out + (blk * block_t + r0 + r) * static_cast<long long>(Dout);
      if (kVec && col + kTN <= Dout) {
        store8(o + col, acc[i]);
      } else {
#pragma unroll
        for (int j = 0; j < kTN; ++j)
          if (col + j < Dout) from_f(o + col + j, acc[i][j]);
      }
    }
  }
}

// Din and Dout are the product's depth and width (kTrans: w[e] is (Dout,
// Din) in memory)
template <typename T, bool kTrans>
int launch(const void* x, const void* w, const int* block_expert,
           const int* block_rows, void* out, int T_rows, int E, int Din,
           int Dout, int block_t, cudaStream_t s) {
  const dim3 grid(T_rows / block_t, (Dout + kBN - 1) / kBN);
  const bool vec =
      Dout % (16 / static_cast<int>(sizeof(T))) == 0 &&
      (kTrans || reinterpret_cast<uintptr_t>(w) % 16 == 0) &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  if (vec)
    gmm_kernel<T, true, kTrans><<<grid, kThreads, 0, s>>>(
        xt, wt, block_expert, block_rows, ot, E, Din, Dout, block_t);
  else
    gmm_kernel<T, false, kTrans><<<grid, kThreads, 0, s>>>(
        xt, wt, block_expert, block_rows, ot, E, Din, Dout, block_t);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the tensor-core kernel (bfloat16)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMmaThreads = 128;   // 4 warps, 32 output columns each
constexpr int kMmaBN = 128;        // output columns per CTA
constexpr int kMmaBK = 64;         // depth per stage
constexpr int kStages = 4;         // cp.async ring depth
constexpr int kWS = kMmaBN + 8;    // shared row strides in bf16: 16 bytes of
constexpr int kXS = kMmaBK + 8;    // padding, so ldmatrix is conflict-free

// one ring stage: the weight tile (kMmaBK x kMmaBN k-major), then kMT*16
// rows of x
constexpr int kWTile = kMmaBK * kWS;
template <int kMT>
__host__ __device__ constexpr int stage_elems() {
  return kWTile + kMT * 16 * kXS;
}
template <int kMT>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * kStages * stage_elems<kMT>();
}

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

__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
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

// grid: one CTA per (block, 128 output columns), the columns of a block
// adjacent in launch order
template <int kMT>
__global__ void __launch_bounds__(kMmaThreads)
    gmm_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const int* __restrict__ block_expert,
                   const int* __restrict__ block_rows, bf16* __restrict__ out,
                   int E, int Din, int Dout, int block_t, int n_col_tiles) {
  constexpr int kRows = kMT * 16;  // rows per chunk
  constexpr int kStage = stage_elems<kMT>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long blk = blockIdx.x / n_col_tiles;
  const int n0 = (blockIdx.x % n_col_tiles) * kMmaBN;
  const int live = block_count(block_rows, blk, block_t);
  bf16* ob = out + blk * block_t * static_cast<long long>(Dout);
  const uint4 zero = make_uint4(0, 0, 0, 0);

  // rows past the count are zeros; a block with no counted row ends here,
  // without a read of w
  for (int i = tid; i < (block_t - live) * (kMmaBN / 8); i += kMmaThreads) {
    const int r = live + i / (kMmaBN / 8), c = n0 + (i % (kMmaBN / 8)) * 8;
    if (c < Dout)
      *reinterpret_cast<uint4*>(ob + static_cast<long long>(r) * Dout + c) =
          zero;
  }
  if (live == 0) return;

  const int e = min(max(block_expert[blk], 0), E - 1);
  const bf16* we = w + static_cast<long long>(e) * Din * Dout;
  const int n_k = (Din + kMmaBK - 1) / kMmaBK;
  const int g = lane >> 2, t4 = lane & 3;

  for (int r0 = 0; r0 < live; r0 += kRows) {
    const int rows = min(kRows, live - r0);    // counted rows of the chunk
    const int mt_live = (rows + 15) / 16;      // m16 tiles that hold them
    const bf16* xb = x + (blk * block_t + r0) * static_cast<long long>(Din);

    // weight tile k-step kt and the chunk's x slice into ring stage s
    auto stage = [&](int kt, int s) {
      bf16* ws = smem + s * kStage;
      bf16* xs = ws + kWTile;
      const int k0 = kt * kMmaBK;
#pragma unroll
      for (int it = 0; it < kMmaBK * (kMmaBN / 8) / kMmaThreads; ++it) {
        const int i = tid + it * kMmaThreads;
        const int r = i / (kMmaBN / 8), c = (i % (kMmaBN / 8)) * 8;
        const bool ok = k0 + r < Din && n0 + c < Dout;
        cp_async16(ws + r * kWS + c,
                   ok ? we + static_cast<long long>(k0 + r) * Dout + n0 + c
                      : we,
                   ok);
      }
#pragma unroll
      for (int it = 0; it < kRows * (kMmaBK / 8) / kMmaThreads; ++it) {
        const int i = tid + it * kMmaThreads;
        const int r = i / (kMmaBK / 8), c = (i % (kMmaBK / 8)) * 8;
        const bool ok = r < rows && k0 + c < Din;
        cp_async16(xs + r * kXS + c,
                   ok ? xb + static_cast<long long>(r) * Din + k0 + c : xb,
                   ok);
      }
    };

    float acc[kMT][4][4];
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][n][j] = 0.f;

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_k) stage(s, s);
      cp_async_commit();
    }
    for (int kt = 0; kt < n_k; ++kt) {
      cp_async_wait<kStages - 2>();  // step kt has landed
      __syncthreads();               // ... for all, and step kt-1 is done
      if (kt + kStages - 1 < n_k)
        stage(kt + kStages - 1, (kt + kStages - 1) % kStages);
      cp_async_commit();
      const bf16* ws = smem + (kt % kStages) * kStage;
      const bf16* xs = ws + kWTile;
#pragma unroll
      for (int kk = 0; kk < kMmaBK / 16; ++kk) {
        unsigned a[kMT][4];
#pragma unroll
        for (int m = 0; m < kMT; ++m)
          if (m < mt_live)
            ldsm_x4(a[m], xs + (m * 16 + (lane & 15)) * kXS + kk * 16 +
                              (lane >> 4) * 8);
#pragma unroll
        for (int dn = 0; dn < 2; ++dn) {  // column tiles 2*dn, 2*dn + 1
          unsigned b[4];
          ldsm_x4_trans(b, ws + (kk * 16 + (lane & 7) +
                                 ((lane >> 3) & 1) * 8) * kWS +
                               warp * 32 + dn * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int m = 0; m < kMT; ++m)
            if (m < mt_live) {
              mma_bf16(acc[m][2 * dn], a[m], b[0], b[1]);
              mma_bf16(acc[m][2 * dn + 1], a[m], b[2], b[3]);
            }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();               // the ring is free for the output tile

    // round once to bf16 into shared memory, rows past the count as zeros
    bf16* os = smem;
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m * 16 + g + h * 8;
          const bool ok = r < rows;
          *reinterpret_cast<__nv_bfloat162*>(
              os + r * kWS + warp * 32 + n * 8 + 2 * t4) =
              __floats2bfloat162_rn(ok ? acc[m][n][2 * h] : 0.f,
                                    ok ? acc[m][n][2 * h + 1] : 0.f);
        }
    __syncthreads();
    for (int i = tid; i < rows * (kMmaBN / 8); i += kMmaThreads) {
      const int r = i / (kMmaBN / 8), c = (i % (kMmaBN / 8)) * 8;
      if (n0 + c < Dout)
        *reinterpret_cast<uint4*>(
            ob + static_cast<long long>(r0 + r) * Dout + n0 + c) =
            *reinterpret_cast<const uint4*>(os + r * kWS + c);
    }
    __syncthreads();               // before the next chunk refills the ring
  }
}

template <int kMT>
int launch_mma(const void* x, const void* w, const int* block_expert,
               const int* block_rows, void* out, int T_rows, int E, int Din,
               int Dout, int block_t, cudaStream_t s) {
  constexpr size_t kSmem = mma_smem_bytes<kMT>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        gmm_mma_kernel<kMT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int n_col = (Dout + kMmaBN - 1) / kMmaBN;
  const long long ctas = static_cast<long long>(T_rows / block_t) * n_col;
  if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  gmm_mma_kernel<kMT><<<static_cast<unsigned>(ctas), kMmaThreads, kSmem,
                        s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), block_expert,
      block_rows, static_cast<bf16*>(out), E, Din, Dout, block_t, n_col);
  return static_cast<int>(cudaGetLastError());
}

// the checks and dispatch of the C entries below; Din and Dout are the
// product's depth and width
template <bool kTrans>
int gmm_simt(int dtype, const void* x, const void* w, const int* block_expert,
             const int* block_rows, void* out, int T, int E, int Din,
             int Dout, int block_t, void* stream) {
  if (T < 0 || E < 1 || Din < 0 || Dout < 0 || block_t < 1 || T % block_t)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((Dout + kBN - 1) / kBN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0 || Dout == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, kTrans>(x, w, block_expert, block_rows, out, T, E,
                                 Din, Dout, block_t, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, kTrans>(x, w, block_expert, block_rows, out,
                                         T, E, Din, Dout, block_t, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int gmm_mma(const void* x, const void* w, const int* block_expert,
            const int* block_rows, void* out, int T, int E, int Din, int Dout,
            int block_t, void* stream) {
  if (T < 0 || E < 1 || Din < 0 || Dout < 0 || block_t < 1 ||
      T % block_t || Din % 8 || Dout % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (T == 0 || Dout == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_t <= 16)
    return launch_mma<1>(x, w, block_expert, block_rows, out, T, E, Din,
                         Dout, block_t, s);
  if (block_t <= 32)
    return launch_mma<2>(x, w, block_expert, block_rows, out, T, E, Din,
                         Dout, block_t, s);
  return launch_mma<4>(x, w, block_expert, block_rows, out, T, E, Din, Dout,
                       block_t, s);
}

}  // namespace

extern "C" {

const char* gmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The CUDA-core kernel.  dtype: 0 = float32, 1 = bfloat16 (x, w and out
// alike); block_expert int32 of T / block_t entries, block_rows the same or
// null (every row counts).  x (T, Din), w (E, Din, Dout), out (T, Dout), all
// contiguous.
int gmm_fwd(int dtype, const void* x, const void* w, const int* block_expert,
            const int* block_rows, void* out, int T, int E, int Din,
            int Dout, int block_t, void* stream) {
  return gmm_simt<false>(dtype, x, w, block_expert, block_rows, out, T, E,
                         Din, Dout, block_t, stream);
}

// The tensor-core kernel: bfloat16 x, w and out, Din % 8 == 0,
// Dout % 8 == 0, every pointer 16-byte aligned (the wrapper checks).  The
// chunk of rows a CTA holds at once follows block_t: 16, 32 or 64 rows.
int gmm_fwd_mma(const void* x, const void* w, const int* block_expert,
                const int* block_rows, void* out, int T, int E, int Din,
                int Dout, int block_t, void* stream) {
  return gmm_mma(x, w, block_expert, block_rows, out, T, E, Din, Dout,
                 block_t, stream);
}

// The input gradient on the CUDA cores: dx (T, Din) = block i of dy (T,
// Dout) times w[block_expert[i]]^T, w (E, Din, Dout) as the forward takes
// it, rows past block_rows zero; the arguments are gmm_fwd's, with dy in
// x's place and dx in out's.
int gmm_dx(int dtype, const void* dy, const void* w, const int* block_expert,
           const int* block_rows, void* dx, int T, int E, int Din, int Dout,
           int block_t, void* stream) {
  return gmm_simt<true>(dtype, dy, w, block_expert, block_rows, dx, T, E,
                        Dout, Din, block_t, stream);
}

}  // extern "C"
