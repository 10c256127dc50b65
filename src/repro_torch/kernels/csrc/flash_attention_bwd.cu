// Flash attention's backward (training), hand-written for Hopper (sm_90a).
//
// Replaces the custom VJP of src/repro/models/flash_xla.py (_flash_bwd,
// registered with defvjp), the FlashAttention-2 backward the JAX trainer
// runs through flash_attention_xla: for q (B, Hq, Sq, D), k, v (B, Hkv, Sk,
// D), Hq = G * Hkv, the forward's out and its row log-sum-exp lse (B, Hq,
// Sq) float32 (flash_attention.cu writes it), and the output gradient dO,
//
//   S = scale * q k^T,  P = exp(S - lse) on the visible keys (0 elsewhere),
//   Dsum = rowsum(dO o out),  dP = dO v^T,  dS = P o (dP - Dsum),
//   dq = scale * dS k,  dk = scale * dS^T q,  dv = P^T dO,
//
// with dk and dv summed over the G query heads of each kv head.  Visibility
// is the forward's: j < Sk, and with `causal` j <= i + offset, and with a
// window w > 0 also j > i + offset - w.  Inputs are read through element
// strides with D contiguous; dq, dk, dv are written contiguous in the input
// dtype.
//
// Three routes, chosen by the wrapper (flash_attention.py, _bwd_variant):
// bf16 rows on 16 bytes at D <= 128 take this file's tensor-core kernels
// (flash_attention_bwd_mma), the same rows at 128 < D <= 256 the wgmma
// kernels of flash_attention_bwd_sm90.cu, and float32 or rows off 16
// bytes this file's CUDA-core kernels (flash_attention_bwd).  This file's
// two routes are each three kernels launched in order on the caller's
// stream by one C entry point, with no atomics, so two calls give
// bitwise-equal gradients:
//   dsum_kernel  one warp a row: Dsum = rowsum(dO o out), float32 scratch;
//   dK/dV walk   one block per (key tile, kv head, b): the key tile's K and
//                V stay in shared memory while the block walks the G query
//                heads and every query tile that sees the key tile,
//                recomputing P and dS a tile pair at a time and
//                accumulating dk and dv in registers;
//   dQ walk      one block per (query tile, q head, b): walks the key tiles
//                the query tile sees (the forward's range), accumulating dq
//                in registers; the query tiles with the most keys first.
// Tiles wholly outside the causal or window mask are skipped.
//
// Bound: operations.  The five tile products cost 10 * D FLOP a visible
// (query, key) pair a head; at llama3.2-3b's training shape (B 2, 24/8
// heads, S 4096, D 128, causal) that is 515.6 GFLOP over the visible half,
// 0.52 ms at the tensor cores' bf16 peak of 989 TFLOP/s.  Both routes
// recompute S and dP in each walk, seven products in all.
//
// flash_attention_bwd_mma (bfloat16, D % 8 == 0 and D <= 128, every row on
// 16 bytes): the tile products on the tensor cores, mma.sync m16n8k16 (bf16
// in, float32 accumulate), 4 warps a block, tiles of 64 keys and 64
// queries, rows padded by 16 bytes in shared memory so every ldmatrix phase
// hits 8 distinct bank groups.  dkdv_mma_kernel: each warp owns 16 keys;
// K and V are staged once, Q, dO, lse and Dsum stream through a 2-stage
// cp.async ring (16-byte copies of the bf16 rows as they are, 4-byte ones
// of lse and Dsum) so query tile t+1 loads while tile t computes.  S^T = K.Q^T and dP^T = V.dO^T take Q and dO as B
// fragments by ldmatrix; P^T and dS^T are made in registers from the C
// fragments and, rounded to bf16, are as they stand the A fragments of
// dV += P^T.dO and dK += dS^T.Q (the C layout of m16n8 is the A layout of
// m16k16), whose B fragments come by ldmatrix.trans; P^T and dS^T never
// touch shared memory.  At D 128 a step takes 32 of the tile's queries, so
// S^T and dP^T (16 registers each) sit beside the 128 float32 registers
// of dK and dV without spilling.  Key tiles launch heaviest first: the grid
// is flat with the key tile slowest, and under a causal mask key tile 0
// sees every query tile.  dq_mma_kernel: each warp owns 16 queries; Q and
// dO are staged once, K and V stream through the same ring; S = Q.K^T and
// dP = dO.V^T, then dS in registers, rounded to bf16, is the A operand of
// dQ += dS.K (K's B fragments by ldmatrix.trans); lse and Dsum of a lane's
// two rows sit in registers; the query tiles with the most keys launch
// first.  Each kernel takes six bf16 tiles of shared memory (105 KB at D
// 128) and up to 255 registers a thread: two blocks, 8 warps, an SM.
// Masks are applied in registers, only on tiles that cross the diagonal,
// the window's edge or the ragged end.  Numerics: P and dS are
// rounded to bf16 before their products, as the forward rounds P; sums are
// float32 and dq, dk, dv are rounded once, at the end.  Templated on D up
// to 64 or 128; a D in between is zero-filled in shared memory.  At D 192
// and 256 the dK and dV accumulators of 16 keys a warp alone (192 and 256
// float32 registers a lane) pass the 255-register limit, so those widths
// take the wgmma route, whose warpgroups hold an m64 x D accumulator in
// D / 2 registers a thread.
//
// flash_attention_bwd (float32, and bf16 rows off 16 bytes at any D):
// everything on the CUDA cores in float32.  Every tile is staged in
// shared memory as float32 with an odd row stride, so the column walks of
// the products (A[row][k] with k running, B[k][col] with col across the
// lanes) hit distinct banks; each thread of 256 holds a (T/16) x (T/16)
// block of scores and a (T/16) x (DMax/16) block of its accumulators, row
// t = ty + 16 r and column tx + 16 c.  Templated on (DMax, T): (64, 64),
// (128, 64) and (256, 32), 108 to 174 KB of shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, Hq, Sq)
  float* dsum;       // (B, Hq, Sq) scratch
  void* dq;          // (B, Hq, Sq, D) contiguous
  void* dk;          // (B, Hkv, Sk, D) contiguous
  void* dv;
  int B, Hq, Hkv, Sq, Sk, D;
  long long q_sb, q_sh, q_ss;  // element strides; the D axis is contiguous
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  long long do_sb, do_sh, do_ss;
  float scale;
  int causal, window, offset;
};

__device__ __forceinline__ bool visible(const Args& a, int i, int j) {
  bool ok = i < a.Sq && j < a.Sk;
  if (a.causal) ok = ok && j <= i + a.offset;
  if (a.window > 0) ok = ok && j > i + a.offset - a.window;
  return ok;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) dsum_kernel(Args a) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<long long>(a.B) * a.Hq * a.Sq) return;
  const int i = static_cast<int>(row % a.Sq);
  const long long bh = row / a.Sq;
  const int h = static_cast<int>(bh % a.Hq);
  const int b = static_cast<int>(bh / a.Hq);
  const T* o =
      static_cast<const T*>(a.o) + b * a.o_sb + h * a.o_sh + i * a.o_ss;
  const T* d = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh +
               i * a.do_ss;
  float s = 0.f;
  for (int c = lane; c < a.D; c += 32) s = fmaf(to_f(o[c]), to_f(d[c]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) a.dsum[row] = s;
}

// rows [row0, row0 + kT) of a (rows, D) matrix with row stride ss into a
// kT x kLd float32 tile; rows past n_rows and columns in [D, kDMax) are zeros
template <typename T, int kT, int kLd, int kDMax>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long ss, int row0, int n_rows,
                                          int D) {
  for (int e = threadIdx.x; e < kT * kDMax; e += kThreads) {
    const int r = e / kDMax, d = e - r * kDMax;
    const int row = row0 + r;
    dst[r * kLd + d] = (row < n_rows && d < D) ? to_f(src[row * ss + d]) : 0.f;
  }
}

// out[r][c] = sum_{d < D} A[(ty + 16 r) * kLd + d] * B[(tx + 16 c) * kLd + d]
template <int kR, int kLd>
__device__ __forceinline__ void product_nt(float (&out)[kR][kR],
                                           const float* A, const float* B,
                                           int D, int ty, int tx) {
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int c = 0; c < kR; ++c) out[r][c] = 0.f;
  for (int d = 0; d < D; ++d) {
    float av[kR], bv[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) av[r] = A[(ty + 16 * r) * kLd + d];
#pragma unroll
    for (int c = 0; c < kR; ++c) bv[c] = B[(tx + 16 * c) * kLd + d];
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int c = 0; c < kR; ++c) out[r][c] = fmaf(av[r], bv[c], out[r][c]);
  }
}

// acc[r][c] += sum_{k < kK} A[k * kLa + ty + 16 r] * B[k * kLb + tx + 16 c]
template <int kR, int kC, int kK, int kLa, int kLb>
__device__ __forceinline__ void product_tn(float (&acc)[kR][kC],
                                           const float* A, const float* B,
                                           int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < kK; ++k) {
    float av[kR], bv[kC];
#pragma unroll
    for (int r = 0; r < kR; ++r) av[r] = A[k * kLa + ty + 16 * r];
#pragma unroll
    for (int c = 0; c < kC; ++c) bv[c] = B[k * kLb + tx + 16 * c];
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// shared memory of a kernel: n_d tiles of kT x (kDMax + 1), n_p of
// kT x (kT + 17) (a row stride of 17 mod 32, so the two half-warps' stores
// of a score row land on distinct banks), lse and Dsum
template <int kDMax, int kT>
constexpr size_t smem_bytes(int n_d, int n_p) {
  return sizeof(float) *
         (n_d * kT * (kDMax + 1) + n_p * kT * (kT + 17) + 2 * kT);
}

template <typename T, int kDMax, int kT>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(Args a) {
  constexpr int kR = kT / 16;     // score rows and cols, dk / dv rows a thread
  constexpr int kC = kDMax / 16;  // dk / dv columns a thread
  constexpr int kLd = kDMax + 1;
  constexpr int kLp = kT + 17;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;               // [kT][kLd]
  float* Vs = Ks + kT * kLd;
  float* Qs = Vs + kT * kLd;
  float* dOs = Qs + kT * kLd;
  float* Ps = dOs + kT * kLd;     // [kT queries][kLp]
  float* dSs = Ps + kT * kLp;     // [kT queries][kLp]
  float* lse_s = dSs + kT * kLp;  // [kT]
  float* dsum_s = lse_s + kT;     // [kT]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * kT;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.Hq / a.Hkv;
  const int D = a.D;
  load_tile<T, kT, kLd, kDMax>(
      Ks, static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh, a.k_ss, k0,
      a.Sk, D);
  load_tile<T, kT, kLd, kDMax>(
      Vs, static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh, a.v_ss, k0,
      a.Sk, D);

  // the query rows that see a key of this tile
  const int k_last = min(k0 + kT, a.Sk) - 1;
  int q_begin = 0, q_end = a.Sq;
  if (a.causal) q_begin = max(0, k0 - a.offset);
  if (a.window > 0) q_end = min(q_end, k_last - a.offset + a.window);

  float dk[kR][kC], dv[kR][kC];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int c = 0; c < kC; ++c) dk[r][c] = dv[r][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
    const T* dout =
        static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
    const long long row0 = (static_cast<long long>(b) * a.Hq + h) * a.Sq;
    for (int q0 = q_begin; q0 < q_end; q0 += kT) {
      __syncthreads();  // the previous tile pair's readers are done
      load_tile<T, kT, kLd, kDMax>(Qs, q, a.q_ss, q0, a.Sq, D);
      load_tile<T, kT, kLd, kDMax>(dOs, dout, a.do_ss, q0, a.Sq, D);
      if (tid < kT) {
        const int i = q0 + tid;
        lse_s[tid] = i < a.Sq ? a.lse[row0 + i] : 0.f;
        dsum_s[tid] = i < a.Sq ? a.dsum[row0 + i] : 0.f;
      }
      __syncthreads();
      float s[kR][kR], dp[kR][kR];
      product_nt<kR, kLd>(s, Qs, Ks, D, ty, tx);
      product_nt<kR, kLd>(dp, dOs, Vs, D, ty, tx);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int ti = ty + 16 * r;
#pragma unroll
        for (int c = 0; c < kR; ++c) {
          const int tj = tx + 16 * c;
          const float p = visible(a, q0 + ti, k0 + tj)
                              ? expf(s[r][c] * a.scale - lse_s[ti])
                              : 0.f;
          Ps[ti * kLp + tj] = p;
          dSs[ti * kLp + tj] = p * (dp[r][c] - dsum_s[ti]);
        }
      }
      __syncthreads();
      product_tn<kR, kC, kT, kLp, kLd>(dv, Ps, dOs, ty, tx);
      product_tn<kR, kC, kT, kLp, kLd>(dk, dSs, Qs, ty, tx);
    }
  }

  T* dkp = static_cast<T*>(a.dk) +
           (static_cast<long long>(b) * a.Hkv + hk) * a.Sk * D;
  T* dvp = static_cast<T*>(a.dv) +
           (static_cast<long long>(b) * a.Hkv + hk) * a.Sk * D;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int j = k0 + ty + 16 * r;
    if (j >= a.Sk) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) {
        store(dkp + static_cast<long long>(j) * D + col, dk[r][c] * a.scale);
        store(dvp + static_cast<long long>(j) * D + col, dv[r][c]);
      }
    }
  }
}

template <typename T, int kDMax, int kT>
__global__ void __launch_bounds__(kThreads) dq_kernel(Args a) {
  constexpr int kR = kT / 16;
  constexpr int kC = kDMax / 16;
  constexpr int kLd = kDMax + 1;
  constexpr int kLp = kT + 17;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;               // [kT][kLd]
  float* dOs = Qs + kT * kLd;
  float* Ks = dOs + kT * kLd;
  float* Vs = Ks + kT * kLd;
  float* dSt = Vs + kT * kLd;     // [kT keys][kLp]: dS transposed
  float* lse_s = dSt + kT * kLp;  // [kT]
  float* dsum_s = lse_s + kT;     // [kT]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  // the query tiles with the most keys (the last, under a causal mask)
  // start first, so the short ones fill the tail of the launch
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int D = a.D;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const long long row0 = (static_cast<long long>(b) * a.Hq + h) * a.Sq;
  load_tile<T, kT, kLd, kDMax>(
      Qs, static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh, a.q_ss, q0,
      a.Sq, D);
  load_tile<T, kT, kLd, kDMax>(
      dOs, static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh,
      a.do_ss, q0, a.Sq, D);
  if (tid < kT) {
    const int i = q0 + tid;
    lse_s[tid] = i < a.Sq ? a.lse[row0 + i] : 0.f;
    dsum_s[tid] = i < a.Sq ? a.dsum[row0 + i] : 0.f;
  }

  // the key range any row of this tile sees, as in the forward
  const int q_last = min(q0 + kT, a.Sq) - 1;
  int k_end = a.Sk;
  if (a.causal) k_end = min(k_end, q_last + a.offset + 1);
  int k_begin = 0;
  if (a.window > 0) k_begin = max(0, q0 + a.offset - a.window + 1);

  float dq[kR][kC];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int c = 0; c < kC; ++c) dq[r][c] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kT) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, kT, kLd, kDMax>(Ks, k, a.k_ss, k0, a.Sk, D);
    load_tile<T, kT, kLd, kDMax>(Vs, v, a.v_ss, k0, a.Sk, D);
    __syncthreads();
    float s[kR][kR], dp[kR][kR];
    product_nt<kR, kLd>(s, Qs, Ks, D, ty, tx);
    product_nt<kR, kLd>(dp, dOs, Vs, D, ty, tx);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int ti = ty + 16 * r;
#pragma unroll
      for (int c = 0; c < kR; ++c) {
        const int tj = tx + 16 * c;
        const float p = visible(a, q0 + ti, k0 + tj)
                            ? expf(s[r][c] * a.scale - lse_s[ti])
                            : 0.f;
        dSt[tj * kLp + ti] = p * (dp[r][c] - dsum_s[ti]);
      }
    }
    __syncthreads();
    product_tn<kR, kC, kT, kLp, kLd>(dq, dSt, Ks, ty, tx);
  }

  T* dqp = static_cast<T*>(a.dq) + row0 * D;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = q0 + ty + 16 * r;
    if (i >= a.Sq) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int col = tx + 16 * c;
      if (col < D)
        store(dqp + static_cast<long long>(i) * D + col, dq[r][c] * a.scale);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int kDMax, int kT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t kDkdvBytes = smem_bytes<kDMax, kT>(4, 2);
  constexpr size_t kDqBytes = smem_bytes<kDMax, kT>(4, 1);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = allow_smem(dkdv_kernel<T, kDMax, kT>, kDkdvBytes);
    if (err != cudaSuccess) return err;
    err = allow_smem(dq_kernel<T, kDMax, kT>, kDqBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const long long rows = static_cast<long long>(a.B) * a.Hq * a.Sq;
  if (rows > 0) {
    const unsigned blocks =
        static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32));
    dsum_kernel<T><<<blocks, kThreads, 0, stream>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (a.Sk > 0) {
    const dim3 grid((a.Sk + kT - 1) / kT, a.Hkv, a.B);
    dkdv_kernel<T, kDMax, kT><<<grid, kThreads, kDkdvBytes, stream>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (a.Sq > 0) {
    const dim3 grid((a.Sq + kT - 1) / kT, a.Hq, a.B);
    dq_kernel<T, kDMax, kT><<<grid, kThreads, kDqBytes, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  if (a.D <= 64) return launch<T, 64, 64>(a, stream);
  if (a.D <= 128) return launch<T, 128, 64>(a, stream);
  return launch<T, 256, 32>(a, stream);
}

// ---------------------------------------------------------------------------
// the tensor-core kernels (bfloat16)
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps x 16 rows of a 64-row tile
constexpr int kMmaT = 64;         // keys of a dK/dV tile, queries of a dQ one
constexpr float kLog2e = 1.4426950408889634f;

// shared-memory row stride in bf16 elements (16 bytes of padding) and the
// bytes of one staged 64-row tile
template <int kDP>
__host__ __device__ constexpr int row_stride() { return kDP + 8; }
template <int kDP>
constexpr size_t tile_bytes() {
  return sizeof(__nv_bfloat16) * kMmaT * row_stride<kDP>();
}

// 2^x by the SFU's approximation (relative error ~2^-22, far below the bf16
// rounding of P and dS that follows)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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
// 4 bytes global -> shared (a float of lse or Dsum, whose rows need not
// start on 16 bytes); zero when valid == false
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
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

// two floats rounded to a bf16x2 register (lo in the low half)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// rows [row0, row0 + kMmaT) of a (rows, D) bf16 matrix with row stride `ss`
// into a kMmaT x kDP shared tile; rows past n_rows and columns past D are
// zeros
template <int kDP>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long ss, int row0, int n_rows,
                                           int D, int tid) {
  constexpr int kChunks = kDP / 8;  // 16-byte chunks per row
#pragma unroll
  for (int it = 0; it < kMmaT * kChunks / kMmaThreads; ++it) {
    const int i = tid + it * kMmaThreads;
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = row0 + r < n_rows && c * 8 < D;
    cp_async16(dst + r * row_stride<kDP>() + c * 8,
               ok ? src + (row0 + r) * ss + c * 8 : src, ok);
  }
}

// whether the 64 x 64 tile of queries [q0, q0 + 64) and keys [k0, k0 + 64)
// holds a pair that is not visible, so that its scores need the mask
__device__ __forceinline__ bool crosses_edge(const Args& a, int q0, int k0) {
  return q0 + kMmaT > a.Sq || k0 + kMmaT > a.Sk ||
         (a.causal && k0 + kMmaT - 1 > q0 + a.offset) ||
         (a.window > 0 && k0 <= q0 + kMmaT - 1 + a.offset - a.window);
}

// step t of a dK/dV block's walk (head g = t / n_qt of the kv head's group,
// its query tile t % n_qt) into one stage of the ring: the Q and dO tiles
// and the tile's lse and Dsum, one float a thread
template <int kDP>
__device__ __forceinline__ void stage_query_step(
    const Args& a, int hk, int b, int q_begin, int n_qt, int t,
    __nv_bfloat16* Qd, __nv_bfloat16* dOd, float* lse_d, float* dsum_d,
    int tid) {
  const int h = hk * (a.Hq / a.Hkv) + t / n_qt;
  const int q0 = q_begin + (t % n_qt) * kMmaT;
  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* dout =
      static_cast<const __nv_bfloat16*>(a.dout) + b * a.do_sb + h * a.do_sh;
  stage_tile<kDP>(Qd, q, a.q_ss, q0, a.Sq, a.D, tid);
  stage_tile<kDP>(dOd, dout, a.do_ss, q0, a.Sq, a.D, tid);
  const long long row0 = (static_cast<long long>(b) * a.Hq + h) * a.Sq;
  const int r = tid & (kMmaT - 1);  // threads 0-63 lse, 64-127 Dsum
  const bool ok = q0 + r < a.Sq;
  const float* src = (tid < kMmaT ? a.lse : a.dsum) + row0 + (ok ? q0 + r : 0);
  cp_async4((tid < kMmaT ? lse_d : dsum_d) + r, src, ok);
}

// dK and dV of one 64-key tile of one kv head; kQH queries a step (32 or
// 64) bound the registers of S^T and dP^T beside the accumulators
template <int kDP, int kQH>
__global__ void __launch_bounds__(kMmaThreads) dkdv_mma_kernel(Args a) {
  constexpr int kS = row_stride<kDP>();
  constexpr int kTile = kMmaT * kS;
  constexpr int kNT = kDP / 8;  // 8-column tiles of dK and dV a warp
  constexpr int kQT = kQH / 8;  // 8-query tiles of a step's S^T and dP^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + kTile;
  __nv_bfloat16* Qs = Vs + kTile;       // stages 0, 1
  __nv_bfloat16* dOs = Qs + 2 * kTile;  // stages 0, 1
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * kTile);  // [2][kMmaT]
  float* dsum_s = lse_s + 2 * kMmaT;                         // [2][kMmaT]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the key tile varies slowest over the flat grid, so the heaviest tiles
  // (tile 0 under a causal mask) of every head start first
  const int heads = a.Hkv * a.B;
  const int k0 = static_cast<int>(blockIdx.x / heads) * kMmaT;
  const int hk = static_cast<int>(blockIdx.x % heads) % a.Hkv;
  const int b = static_cast<int>(blockIdx.x % heads) / a.Hkv;
  const int D = a.D;

  // the query rows that see a key of this tile, in whole 64-row tiles
  const int k_last = min(k0 + kMmaT, a.Sk) - 1;
  int q_begin = 0, q_end = a.Sq;
  if (a.causal) q_begin = max(0, k0 - a.offset);
  if (a.window > 0) q_end = min(q_end, k_last - a.offset + a.window);
  q_begin = (q_begin / kMmaT) * kMmaT;
  const int n_qt =
      q_end > q_begin ? (q_end - q_begin + kMmaT - 1) / kMmaT : 0;
  const int n_steps = (a.Hq / a.Hkv) * n_qt;

  if (n_steps > 0) {
    stage_tile<kDP>(Ks,
                    static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb +
                        hk * a.k_sh,
                    a.k_ss, k0, a.Sk, D, tid);
    stage_tile<kDP>(Vs,
                    static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb +
                        hk * a.v_sh,
                    a.v_ss, k0, a.Sk, D, tid);
    stage_query_step<kDP>(a, hk, b, q_begin, n_qt, 0, Qs, dOs, lse_s, dsum_s,
                          tid);
  }
  cp_async_commit();

  // thread (g, t4) of a warp holds keys key_lo = g and g + 8 of the warp's
  // 16, and columns 2*t4, 2*t4 + 1 of every 8-column tile
  const int g = lane >> 2, t4 = lane & 3;
  const int key_lo = warp * 16 + g;
  const float scale_log2 = a.scale * kLog2e;
  float dk[kNT][4], dv[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int t = 0; t < n_steps; ++t) {
    if (t + 1 < n_steps) {  // the next step loads while this one computes
      const int nxt = (t + 1) & 1;
      stage_query_step<kDP>(a, hk, b, q_begin, n_qt, t + 1,
                            Qs + nxt * kTile, dOs + nxt * kTile,
                            lse_s + nxt * kMmaT, dsum_s + nxt * kMmaT, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Qt = Qs + (t & 1) * kTile;
    const __nv_bfloat16* dOt = dOs + (t & 1) * kTile;
    const float* lse_t = lse_s + (t & 1) * kMmaT;
    const float* dsum_t = dsum_s + (t & 1) * kMmaT;
    const int q0 = q_begin + (t % n_qt) * kMmaT;
    const bool edge = crosses_edge(a, q0, k0);

#pragma unroll 1
    for (int qh = 0; qh < kMmaT; qh += kQH) {
      // S^T = K . Q^T and dP^T = V . dO^T: 16 keys x kQH queries a warp
      float s[kQT][4], dp[kQT][4];
#pragma unroll
      for (int n = 0; n < kQT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kDP / 16; ++kk) {
        unsigned ka[4], va[4];
        const int a_off = (warp * 16 + (lane & 15)) * kS + kk * 16 +
                          (lane >> 4) * 8;
        ldsm_x4(ka, Ks + a_off);
        ldsm_x4(va, Vs + a_off);
#pragma unroll
        for (int nj = 0; nj < kQT / 2; ++nj) {  // query tiles 2nj, 2nj + 1
          const int b_off =
              (qh + nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * kS +
              kk * 16 + ((lane >> 3) & 1) * 8;
          unsigned qb[4], ob[4];
          ldsm_x4(qb, Qt + b_off);
          ldsm_x4(ob, dOt + b_off);
          mma_bf16(s[2 * nj], ka, qb[0], qb[1]);
          mma_bf16(s[2 * nj + 1], ka, qb[2], qb[3]);
          mma_bf16(dp[2 * nj], va, ob[0], ob[1]);
          mma_bf16(dp[2 * nj + 1], va, ob[2], ob[3]);
        }
      }

      // P^T = exp(scale S^T - lse) and dS^T = P^T o (dP^T - Dsum), lse and
      // Dsum per query (a column); masked only on a tile across an edge
      unsigned pa[kQH / 16][4], da[kQH / 16][4];
#pragma unroll
      for (int n = 0; n < kQT; ++n) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = qh + n * 8 + 2 * t4 + (e & 1);
          float x = fast_exp2(fmaf(s[n][e], scale_log2, -lse_t[qi] * kLog2e));
          if (edge) {
            const int i = q0 + qi;
            const int j = k0 + key_lo + (e >> 1) * 8;
            bool ok = i < a.Sq && j < a.Sk;
            if (a.causal) ok = ok && j <= i + a.offset;
            if (a.window > 0) ok = ok && j > i + a.offset - a.window;
            if (!ok) x = 0.f;
          }
          p[e] = x;
          ds[e] = x * (dp[n][e] - dsum_t[qi]);
        }
        // the C fragment of query tile n is half of the A fragment of the
        // 16-query step n / 2
        pa[n >> 1][2 * (n & 1)] = pack_bf16(p[0], p[1]);
        pa[n >> 1][2 * (n & 1) + 1] = pack_bf16(p[2], p[3]);
        da[n >> 1][2 * (n & 1)] = pack_bf16(ds[0], ds[1]);
        da[n >> 1][2 * (n & 1) + 1] = pack_bf16(ds[2], ds[3]);
      }

      // dV += P^T . dO and dK += dS^T . Q: B fragments by ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < kQH / 16; ++kk) {
#pragma unroll
        for (int dn = 0; dn < kDP / 16; ++dn) {  // column tiles 2dn, 2dn + 1
          const int b_off =
              (qh + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kS +
              dn * 16 + (lane >> 4) * 8;
          unsigned ob[4], qb[4];
          ldsm_x4_trans(ob, dOt + b_off);
          ldsm_x4_trans(qb, Qt + b_off);
          mma_bf16(dv[2 * dn], pa[kk], ob[0], ob[1]);
          mma_bf16(dv[2 * dn + 1], pa[kk], ob[2], ob[3]);
          mma_bf16(dk[2 * dn], da[kk], qb[0], qb[1]);
          mma_bf16(dk[2 * dn + 1], da[kk], qb[2], qb[3]);
        }
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }

  const long long base = (static_cast<long long>(b) * a.Hkv + hk) * a.Sk;
  __nv_bfloat16* dkp = static_cast<__nv_bfloat16*>(a.dk) + base * D;
  __nv_bfloat16* dvp = static_cast<__nv_bfloat16*>(a.dv) + base * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = k0 + key_lo + r * 8;
    if (j >= a.Sk) continue;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const int col = n * 8 + 2 * t4;
      if (col < D) {
        const long long at = static_cast<long long>(j) * D + col;
        *reinterpret_cast<__nv_bfloat162*>(dkp + at) = __floats2bfloat162_rn(
            dk[n][2 * r] * a.scale, dk[n][2 * r + 1] * a.scale);
        *reinterpret_cast<__nv_bfloat162*>(dvp + at) =
            __floats2bfloat162_rn(dv[n][2 * r], dv[n][2 * r + 1]);
      }
    }
  }
}

// dQ of one 64-query tile of one query head
template <int kDP>
__global__ void __launch_bounds__(kMmaThreads) dq_mma_kernel(Args a) {
  constexpr int kS = row_stride<kDP>();
  constexpr int kTile = kMmaT * kS;
  constexpr int kNT = kDP / 8;    // 8-column tiles of dQ a warp
  constexpr int kKT = kMmaT / 8;  // 8-key tiles of a key tile's S and dP
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + kTile;
  __nv_bfloat16* Ks = dOs + kTile;     // stages 0, 1
  __nv_bfloat16* Vs = Ks + 2 * kTile;  // stages 0, 1

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the query tile varies slowest over the flat grid, the last (the most
  // keys, under a causal mask) first
  const int heads = a.Hq * a.B;
  const int n_q_tiles = (a.Sq + kMmaT - 1) / kMmaT;
  const int q0 =
      (n_q_tiles - 1 - static_cast<int>(blockIdx.x / heads)) * kMmaT;
  const int h = static_cast<int>(blockIdx.x % heads) % a.Hq;
  const int b = static_cast<int>(blockIdx.x % heads) / a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int D = a.D;
  const __nv_bfloat16* k =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const __nv_bfloat16* v =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + hk * a.v_sh;

  // the key range any row of this tile sees, as in the forward
  const int q_last = min(q0 + kMmaT, a.Sq) - 1;
  int k_end = a.Sk;
  if (a.causal) k_end = min(k_end, q_last + a.offset + 1);
  int k_begin = 0;
  if (a.window > 0) k_begin = max(0, q0 + a.offset - a.window + 1);
  k_begin = (k_begin / kMmaT) * kMmaT;
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + kMmaT - 1) / kMmaT : 0;

  stage_tile<kDP>(Qs,
                  static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb +
                      h * a.q_sh,
                  a.q_ss, q0, a.Sq, D, tid);
  stage_tile<kDP>(dOs,
                  static_cast<const __nv_bfloat16*>(a.dout) + b * a.do_sb +
                      h * a.do_sh,
                  a.do_ss, q0, a.Sq, D, tid);
  if (n_tiles > 0) {
    stage_tile<kDP>(Ks, k, a.k_ss, k_begin, a.Sk, D, tid);
    stage_tile<kDP>(Vs, v, a.v_ss, k_begin, a.Sk, D, tid);
  }
  cp_async_commit();

  // thread (g, t4) of a warp holds query rows row_lo = g and g + 8 of the
  // warp's 16, and columns 2*t4, 2*t4 + 1 of every 8-column tile; the rows'
  // lse (in log2 units) and Dsum stay in registers
  const int g = lane >> 2, t4 = lane & 3;
  const int row_lo = q0 + warp * 16 + g;
  const long long row0 = (static_cast<long long>(b) * a.Hq + h) * a.Sq;
  const float scale_log2 = a.scale * kLog2e;
  float lse2[2], dsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row_lo + r * 8;
    lse2[r] = i < a.Sq ? a.lse[row0 + i] * kLog2e : 0.f;
    dsum[r] = i < a.Sq ? a.dsum[row0 + i] : 0.f;
  }
  float dq[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_begin + t * kMmaT;
    if (t + 1 < n_tiles) {  // the next tile loads while this one computes
      const int nxt = (t + 1) & 1;
      stage_tile<kDP>(Ks + nxt * kTile, k, a.k_ss, k0 + kMmaT, a.Sk, D, tid);
      stage_tile<kDP>(Vs + nxt * kTile, v, a.v_ss, k0 + kMmaT, a.Sk, D, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + (t & 1) * kTile;
    const __nv_bfloat16* Vt = Vs + (t & 1) * kTile;
    const bool edge = crosses_edge(a, q0, k0);

    // S = Q . K^T and dP = dO . V^T: 16 queries x 64 keys a warp
    float s[kKT][4], dp[kKT][4];
#pragma unroll
    for (int n = 0; n < kKT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDP / 16; ++kk) {
      unsigned qa[4], oa[4];
      const int a_off =
          (warp * 16 + (lane & 15)) * kS + kk * 16 + (lane >> 4) * 8;
      ldsm_x4(qa, Qs + a_off);
      ldsm_x4(oa, dOs + a_off);
#pragma unroll
      for (int nj = 0; nj < kKT / 2; ++nj) {  // key tiles 2nj, 2nj + 1
        const int b_off = (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * kS +
                          kk * 16 + ((lane >> 3) & 1) * 8;
        unsigned kb[4], vb[4];
        ldsm_x4(kb, Kt + b_off);
        ldsm_x4(vb, Vt + b_off);
        mma_bf16(s[2 * nj], qa, kb[0], kb[1]);
        mma_bf16(s[2 * nj + 1], qa, kb[2], kb[3]);
        mma_bf16(dp[2 * nj], oa, vb[0], vb[1]);
        mma_bf16(dp[2 * nj + 1], oa, vb[2], vb[3]);
      }
    }

    // dS = P o (dP - Dsum), rounded to bf16 as dQ's A fragments
    unsigned da[kMmaT / 16][4];
#pragma unroll
    for (int n = 0; n < kKT; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float x = fast_exp2(fmaf(s[n][e], scale_log2, -lse2[r]));
        if (edge) {
          const int i = row_lo + r * 8;
          const int j = k0 + n * 8 + 2 * t4 + (e & 1);
          bool ok = i < a.Sq && j < a.Sk;
          if (a.causal) ok = ok && j <= i + a.offset;
          if (a.window > 0) ok = ok && j > i + a.offset - a.window;
          if (!ok) x = 0.f;
        }
        ds[e] = x * (dp[n][e] - dsum[r]);
      }
      da[n >> 1][2 * (n & 1)] = pack_bf16(ds[0], ds[1]);
      da[n >> 1][2 * (n & 1) + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dQ += dS . K: K's B fragments by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kMmaT / 16; ++kk) {
#pragma unroll
      for (int dn = 0; dn < kDP / 16; ++dn) {  // column tiles 2dn, 2dn + 1
        unsigned kb[4];
        ldsm_x4_trans(kb, Kt + (kk * 16 + (lane & 7) +
                                ((lane >> 3) & 1) * 8) * kS +
                              dn * 16 + (lane >> 4) * 8);
        mma_bf16(dq[2 * dn], da[kk], kb[0], kb[1]);
        mma_bf16(dq[2 * dn + 1], da[kk], kb[2], kb[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }

  __nv_bfloat16* dqp = static_cast<__nv_bfloat16*>(a.dq) + row0 * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row_lo + r * 8;
    if (i >= a.Sq) continue;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const int col = n * 8 + 2 * t4;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(dqp + static_cast<long long>(i) *
                                                     D +
                                           col) =
            __floats2bfloat162_rn(dq[n][2 * r] * a.scale,
                                  dq[n][2 * r + 1] * a.scale);
    }
  }
}

// kQH: queries a dK/dV step, 32 at D 128, where S^T and dP^T of 64 beside
// the 128 accumulator registers leave ptxas no register to spare
template <int kDP>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  constexpr int kQH = kDP == 64 ? 64 : 32;
  constexpr size_t kDkdvBytes =
      6 * tile_bytes<kDP>() + 4 * kMmaT * sizeof(float);
  constexpr size_t kDqBytes = 6 * tile_bytes<kDP>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = allow_smem(dkdv_mma_kernel<kDP, kQH>, kDkdvBytes);
    if (err != cudaSuccess) return err;
    err = allow_smem(dq_mma_kernel<kDP>, kDqBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const long long rows = static_cast<long long>(a.B) * a.Hq * a.Sq;
  const long long dkdv_blocks =
      static_cast<long long>((a.Sk + kMmaT - 1) / kMmaT) * a.Hkv * a.B;
  const long long dq_blocks =
      static_cast<long long>((a.Sq + kMmaT - 1) / kMmaT) * a.Hq * a.B;
  if (dkdv_blocks > 0x7fffffffLL || dq_blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (rows > 0) {
    const unsigned blocks =
        static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32));
    dsum_kernel<__nv_bfloat16><<<blocks, kThreads, 0, stream>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (dkdv_blocks > 0) {
    dkdv_mma_kernel<kDP, kQH>
        <<<static_cast<unsigned>(dkdv_blocks), kMmaThreads, kDkdvBytes,
           stream>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (dq_blocks > 0)
    dq_mma_kernel<kDP><<<static_cast<unsigned>(dq_blocks), kMmaThreads,
                         kDqBytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out, dout, dq, dk, dv alike);
// lse and dsum float32 (B, Hq, Sq), dsum scratch the call overwrites.
int flash_attention_bwd(int dtype, const void* q, const void* k,
                        const void* v, const void* out, const void* dout,
                        const float* lse, float* dsum, void* dq, void* dk,
                        void* dv, int B, int Hq, int Hkv, int Sq, int Sk,
                        int D, long long q_sb, long long q_sh, long long q_ss,
                        long long k_sb, long long k_sh, long long k_ss,
                        long long v_sb, long long v_sh, long long v_ss,
                        long long o_sb, long long o_sh, long long o_ss,
                        long long do_sb, long long do_sh, long long do_ss,
                        float scale, int causal, int window, int offset,
                        void* stream) {
  if (D < 1 || D > 256 || Hkv < 1 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Hq == 0) return 0;
  const Args a{q,    k,     v,      out,    dout,   lse,  dsum, dq,   dk,
               dv,   B,     Hq,     Hkv,    Sq,     Sk,   D,    q_sb, q_sh,
               q_ss, k_sb,  k_sh,   k_ss,   v_sb,   v_sh, v_ss, o_sb, o_sh,
               o_ss, do_sb, do_sh,  do_ss,  scale,  causal, window, offset};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(dispatch<float>(a, s));
  if (dtype == 1) return static_cast<int>(dispatch<__nv_bfloat16>(a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core route: bfloat16 q, k, v, out and dout, D % 8 == 0 and
// D <= 128, every row start 16-byte aligned (the wrapper checks pointers
// and strides); the rest as flash_attention_bwd.
int flash_attention_bwd_mma(const void* q, const void* k, const void* v,
                            const void* out, const void* dout,
                            const float* lse, float* dsum, void* dq, void* dk,
                            void* dv, int B, int Hq, int Hkv, int Sq, int Sk,
                            int D, long long q_sb, long long q_sh,
                            long long q_ss, long long k_sb, long long k_sh,
                            long long k_ss, long long v_sb, long long v_sh,
                            long long v_ss, long long o_sb, long long o_sh,
                            long long o_ss, long long do_sb, long long do_sh,
                            long long do_ss, float scale, int causal,
                            int window, int offset, void* stream) {
  if (D < 8 || D > 128 || D % 8 != 0 || Hkv < 1 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Hq == 0) return 0;
  const Args a{q,    k,     v,      out,    dout,   lse,  dsum, dq,   dk,
               dv,   B,     Hq,     Hkv,    Sq,     Sk,   D,    q_sb, q_sh,
               q_ss, k_sb,  k_sh,   k_ss,   v_sb,   v_sh, v_ss, o_sb, o_sh,
               o_ss, do_sb, do_sh,  do_ss,  scale,  causal, window, offset};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64) return static_cast<int>(launch_mma<64>(a, s));
  return static_cast<int>(launch_mma<128>(a, s));
}

}  // extern "C"
