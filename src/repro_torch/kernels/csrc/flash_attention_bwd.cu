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
// window w > 0 also j > i + offset - w.  Inputs are float32 or bf16, read
// through element strides with D contiguous; the arithmetic is float32 and
// dq, dk, dv are written contiguous in the input dtype.
//
// Three kernels, launched in order on the caller's stream by one C entry
// point, with no atomics, so two calls give bitwise-equal gradients:
//   dsum_kernel  one warp a row: Dsum = rowsum(dO o out), float32 scratch;
//   dkdv_kernel  one block per (key tile, kv head, b): the key tile's K and
//                V stay in shared memory while the block walks the G query
//                heads and every query tile that sees the key tile,
//                recomputing P and dS a tile pair at a time and
//                accumulating dk and dv in registers;
//   dq_kernel    one block per (query tile, q head, b): walks the key tiles
//                the query tile sees (the forward's range), accumulating dq
//                in registers; the query tiles with the most keys first.
// Tiles wholly outside the causal or window mask are skipped.
//
// Bound: operations.  At llama3.2-3b's training shape (B 2, 24/8 heads,
// S 4096, D 128, causal) the five tile products cost 5 * B * Hq * S^2 * D
// FLOP over the visible half, 515 GFLOP, 0.52 ms at the tensor cores' bf16
// peak; this first version recomputes S and dP in both walks (seven tile
// products) on the CUDA cores in float32, so it sits far above that bound.
// Every tile is staged in shared memory as float32 with an odd row stride,
// so the column walks of the products (A[row][k] with k running, B[k][col]
// with col across the lanes) hit distinct banks; each thread of 256 holds a
// (T/16) x (T/16) block of scores and a (T/16) x (DMax/16) block of its
// accumulators, row t = ty + 16 r and column tx + 16 c.  Templated on
// (DMax, T): (64, 64), (128, 64) and (256, 32), 108 to 174 KB of shared
// memory.  Moving the products onto mma.sync or wgmma is later work.

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

}  // extern "C"
