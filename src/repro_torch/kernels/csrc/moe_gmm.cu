// Grouped matmul (MoE expert FFN), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel gmm (_gmm_kernel) of
// src/repro/kernels/moe_gmm.py.  For x (T, Din), w (E, Din, Dout) and
// block_expert (T / block_t,):
//
//   out[i*block_t : (i+1)*block_t] = x[i*block_t : (i+1)*block_t]
//                                    @ w[block_expert[i]]
//
// accumulated in float32 and written once in x's type, for any block_t >= 1
// that divides T and any Din and Dout: ragged tiles are masked here, nothing
// is padded in memory.  The TPU kernel takes block_expert by scalar prefetch
// into its weight BlockSpec and reduces over Din on its sequential minor grid
// axis with a VMEM accumulator; here each thread block reads its own expert
// id and loops over Din itself, with the sum in registers, so nothing
// carries between thread blocks.
//
// Bound: device-memory bytes.  On the MoE path every block has its own
// expert (block_expert = arange(E)), so a call reads each weight element
// once: 10.7 GB at llama4-maverick's widths against 0.26 TFLOP of products
// in prefill and 0.09 in decode.  The design reads each weight tile from
// device memory once, with 16-byte loads when the widths allow it, and keeps
// the token rows (at most 32 at a time) in shared memory beside it:
//
//   grid  = (T / block_t, ceil(Dout / kBN)), 256 threads;
//   a block loops over its rows in chunks of at most kMR = 32 and, for each,
//   over Din in steps of kBK = 32: it stages the kBK x kBN tile of
//   w[expert] (native type) and the rows x kBK slice of x (as float) in
//   shared memory, then thread (tx, ty) adds the products of rows
//   ty*4 .. ty*4+3 and columns tx*8 .. tx*8+7 into 32 float registers;
//   warps whose rows all lie past the chunk skip the arithmetic, so the
//   decode shape (block_t = 8) spends no work on empty rows.
//
// The products run on the CUDA cores; mma/wgmma, TMA, and skipping blocks
// whose expert received no token are later work.  block_expert values are
// clamped to [0, E) so that no read leaves w.  The C entry point launches on
// the caller's stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
// so a vector lies wholly inside or wholly outside the matrix.
template <typename T, bool kVec>
__device__ __forceinline__ void load_w_tile(T (*ws)[kBN], const T* w, int k0,
                                            int n0, int Din, int Dout) {
  if constexpr (kVec) {
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

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const int* __restrict__ block_expert, T* __restrict__ out,
               int E, int Din, int Dout, int block_t) {
  __shared__ __align__(16) T ws[kBK][kBN];
  __shared__ float xs[kMR][kBK];

  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const long long blk = blockIdx.x;
  const int e = min(max(block_expert[blk], 0), E - 1);
  const T* we = w + static_cast<long long>(e) * Din * Dout;
  const int n0 = blockIdx.y * kBN;
  const int col = n0 + tx * kTN;

  for (int r0 = 0; r0 < block_t; r0 += kMR) {
    const int rows = min(kMR, block_t - r0);
    const T* xb = x + (blk * block_t + r0) * static_cast<long long>(Din);
    const bool active = ty * kTM < rows;     // the same for a whole warp
    float acc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < Din; k0 += kBK) {
      load_w_tile<T, kVec>(ws, we, k0, n0, Din, Dout);
      for (int v = threadIdx.x; v < kMR * kBK; v += kThreads) {
        const int r = v / kBK, k = v % kBK;
        xs[r][k] = (r < rows && k0 + k < Din)
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

template <typename T>
int launch(const void* x, const void* w, const int* block_expert, void* out,
           int T_rows, int E, int Din, int Dout, int block_t,
           cudaStream_t s) {
  const dim3 grid(T_rows / block_t, (Dout + kBN - 1) / kBN);
  const bool vec =
      Dout % (16 / static_cast<int>(sizeof(T))) == 0 &&
      reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  if (vec)
    gmm_kernel<T, true><<<grid, kThreads, 0, s>>>(xt, wt, block_expert, ot,
                                                  E, Din, Dout, block_t);
  else
    gmm_kernel<T, false><<<grid, kThreads, 0, s>>>(xt, wt, block_expert, ot,
                                                   E, Din, Dout, block_t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* gmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16 (x, w and out alike); block_expert int32
// of T / block_t entries.  x (T, Din), w (E, Din, Dout), out (T, Dout), all
// contiguous.
int gmm_fwd(int dtype, const void* x, const void* w, const int* block_expert,
            void* out, int T, int E, int Din, int Dout, int block_t,
            void* stream) {
  if (T < 0 || E < 1 || Din < 0 || Dout < 0 || block_t < 1 || T % block_t)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((Dout + kBN - 1) / kBN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0 || Dout == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, block_expert, out, T, E, Din, Dout, block_t,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, block_expert, out, T, E, Din, Dout,
                                 block_t, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
