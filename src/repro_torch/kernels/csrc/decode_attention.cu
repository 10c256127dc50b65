// Flash-decode: one new query token per sequence against its KV cache,
// hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel decode_attention (_decode_kernel) of
// src/repro/kernels/decode_attention.py.  For q (B, Hq, D), caches
// (B, Hkv, S, D) and lengths (B,) int32:
//
//   out[b,h] = sum_{j < lengths[b]} softmax_j(scale * q[b,h] . k[b,hk,j])
//              v[b,hk,j],       hk = h / G,  G = Hq / Hkv
//
// and zeros where lengths[b] == 0 (the Pallas kernel's l == 0 -> l_safe = 1).
// Scores, the online-softmax statistics and the accumulator are float32; the
// output is cast to the input type once.
//
// As in the Pallas grid, the G query heads that share a kv head are handled
// together, so each cache row is read once for all of them: one thread block
// per (b, kv head) walks the cache in 64-key tiles and stops at lengths[b]
// (the TPU kernel walks every block and masks).  Per tile, each warp scores
// 8 keys: its 32 lanes split the D axis of a key row (coalesced loads) and a
// shuffle reduction finishes each of the G dot products; one warp per head
// then updates (m, l); the 256 threads finally accumulate the G x D outputs
// from the tile's V rows.
//
// The kernel is templated on the head-dimension cap DMax: 128 (each lane
// covers 4 of D's elements) or 256 (8 elements, as recurrentgemma's local
// attention with head_dim 256 and G = 10 query heads on one kv head).
//
// Bound: device-memory bytes (the cache is read once; ~2 FLOP per byte), so
// the design keeps every cache byte to one read.  With one block per
// (b, kv head) the grid is small (B*Hkv blocks); splitting S across blocks
// is left to a later change.  Strided caches (element strides, D contiguous)
// are read in place; q and out are contiguous (B, Hq, D).  The C entry point
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;        // keys per tile
constexpr int kGMax = 16;      // largest query-head group
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
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
  const int32_t* lengths;
  void* o;
  int Hq, Hkv, S, D;
  long long k_sb, k_sh, k_ss;  // element strides; the D axis is contiguous
  long long v_sb, v_sh, v_ss;
  float scale;
};

template <typename T, int kDMax>
__global__ void __launch_bounds__(kThreads) decode_kernel(Args a) {
  constexpr int kLane = kDMax / 32;                // D elements per lane
  constexpr int kAcc = kGMax * kDMax / kThreads;  // outputs per thread
  __shared__ float qs[kGMax * kDMax];
  __shared__ float ps[kGMax][kBK];
  __shared__ float m_s[kGMax], l_s[kGMax], alpha_s[kGMax];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int G = a.Hq / a.Hkv;
  const int D = a.D;
  const int len = max(0, min(a.lengths[b], a.S));
  const T* q = static_cast<const T*>(a.q) +
               (static_cast<long long>(b) * a.Hq + hk * G) * D;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  for (int i = tid; i < kGMax * kDMax; i += kThreads) {
    const int g = i / kDMax, d = i - g * kDMax;
    qs[i] = (g < G && d < D) ? to_f(q[g * D + d]) : 0.f;
  }
  if (tid < kGMax) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int k0 = 0; k0 < len; k0 += kBK) {
    // scores: warp w takes keys w, w+8, ...; lane owns D columns
    // lane*kLane .. lane*kLane+kLane-1
    for (int kk = warp; kk < kBK; kk += kWarps) {
      const int j = k0 + kk;
      float kv[kLane];
#pragma unroll
      for (int e = 0; e < kLane; ++e) {
        const int d = lane * kLane + e;
        kv[e] = (j < len && d < D) ? to_f(k[j * a.k_ss + d]) : 0.f;
      }
      for (int g = 0; g < G; ++g) {
        const float* qg = qs + g * kDMax + lane * kLane;
        float part = qg[0] * kv[0];
#pragma unroll
        for (int e = 1; e < kLane; ++e) part += qg[e] * kv[e];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (lane == 0) ps[g][kk] = j < len ? part * a.scale : kNegInf;
      }
    }
    __syncthreads();

    // online-softmax statistics, one warp per head
    for (int g = warp; g < G; g += kWarps) {
      const float s0 = ps[g][lane], s1 = ps[g][lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = k0 + lane < len ? expf(s0 - m_new) : 0.f;
      const float p1 = k0 + lane + 32 < len ? expf(s1 - m_new) : 0.f;
      ps[g][lane] = p0;
      ps[g][lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // PV: output o = g*kDMax + d, thread tid takes o = tid + i*kThreads
    const int n = min(kBK, len - k0);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int o = tid + i * kThreads;
      const int g = o / kDMax, d = o - g * kDMax;
      if (g < G && d < D) {
        float x = acc[i] * alpha_s[g];
        const T* vcol = v + static_cast<long long>(k0) * a.v_ss + d;
        for (int kk = 0; kk < n; ++kk)
          x = fmaf(ps[g][kk], to_f(vcol[kk * a.v_ss]), x);
        acc[i] = x;
      }
    }
    __syncthreads();  // ps is rewritten by the next tile
  }

  T* out = static_cast<T*>(a.o) + (static_cast<long long>(b) * a.Hq + hk * G) * D;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int o = tid + i * kThreads;
    const int g = o / kDMax, d = o - g * kDMax;
    if (g < G && d < D) {
      const float l = l_s[g];
      store(out + g * D + d, acc[i] / (l == 0.f ? 1.f : l));
    }
  }
}

}  // namespace

extern "C" {

const char* decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16 (q, caches and out alike).
int decode_attention_fwd(int dtype, const void* q, const void* k,
                         const void* v, const int32_t* lengths, void* out,
                         int B, int Hq, int Hkv, int S, int D, long long k_sb,
                         long long k_sh, long long k_ss, long long v_sb,
                         long long v_sh, long long v_ss, float scale,
                         void* stream) {
  if (D < 1 || D > 256 || Hkv < 1 || Hq % Hkv != 0 || Hq / Hkv > kGMax)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Hq == 0) return 0;
  const Args a{q,    k,    v,    lengths, out,  Hq,   Hkv,  S,
               D,    k_sb, k_sh, k_ss,    v_sb, v_sh, v_ss, scale};
  const dim3 grid(Hkv, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D <= 128)
    decode_kernel<float, 128><<<grid, kThreads, 0, s>>>(a);
  else if (dtype == 0)
    decode_kernel<float, 256><<<grid, kThreads, 0, s>>>(a);
  else if (dtype == 1 && D <= 128)
    decode_kernel<__nv_bfloat16, 128><<<grid, kThreads, 0, s>>>(a);
  else if (dtype == 1)
    decode_kernel<__nv_bfloat16, 256><<<grid, kThreads, 0, s>>>(a);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
