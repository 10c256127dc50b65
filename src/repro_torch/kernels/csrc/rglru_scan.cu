// RG-LRU linear recurrence (RecurrentGemma), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel rglru_scan (_rglru_kernel) of
// src/repro/kernels/rglru_scan.py.  For x, log_a (B, S, D), with h_{-1} = 0:
//
//   a_t = exp(log_a_t)
//   h_t = a_t * h_{t-1} + sqrt(max(1 - exp(2 log_a_t), 0)) * x_t
//   y_t = h_t (cast to the input type),   h_final = h_{S-1} (float32)
//
// elementwise over channels, in float32.  The recurrence is sequential in
// time and independent per (b, channel).  The TPU kernel makes time its
// sequential minor grid dimension and carries h in VMEM scratch between time
// blocks; here one thread owns one (b, channel) and loops over time itself,
// with h in a register, so nothing carries between thread blocks.
//
// Bound: device-memory bytes (x and log_a read once, y written once; about
// ten FLOP per element).  Two things stand in the way.  One thread per
// channel makes a small grid (B*D threads: 10,240 at the serving shape), and
// each step would wait one memory latency for its inputs.  So blocks are one
// warp, and the B*D/32 blocks spread over every SM; and each thread loads
// kChunk time steps of x and log_a into registers one chunk ahead of the
// steps it runs, so a chunk's loads are in flight while the previous chunk
// computes and the loop streams.  A time-chunked two-pass scan, which would
// put more threads on the card, is later work.  The ragged S edge is masked
// here; nothing is padded in memory.  x, log_a and y are contiguous; the C
// entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;  // channels per block: one warp
constexpr int kChunk = 16;    // time steps loaded ahead

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// steps t0 .. t0+kChunk-1 of one channel (those below S) into registers
template <typename T>
__device__ __forceinline__ void load_chunk(const T* x, const T* la, int t0,
                                           int S, int D, float (&xv)[kChunk],
                                           float (&lv)[kChunk]) {
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    if (t0 + i < S) {
      const long long o = static_cast<long long>(t0 + i) * D;
      xv[i] = to_f(x[o]);
      lv[i] = to_f(la[o]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rglru_kernel(const T* x, const T* la, T* y, float* h_out, int S, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= D) return;
  const long long base = static_cast<long long>(b) * S * D + d;
  x += base;
  la += base;
  y += base;

  float xn[kChunk], ln[kChunk];
  load_chunk(x, la, 0, S, D, xn, ln);
  float h = 0.f;
  for (int t0 = 0; t0 < S; t0 += kChunk) {
    float xc[kChunk], lc[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      xc[i] = xn[i];
      lc[i] = ln[i];
    }
    if (t0 + kChunk < S) load_chunk(x, la, t0 + kChunk, S, D, xn, ln);
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if (t0 + i < S) {
        const float a = expf(lc[i]);
        const float gate = sqrtf(fmaxf(1.f - expf(2.f * lc[i]), 0.f));
        h = a * h + gate * xc[i];
        store(y + static_cast<long long>(t0 + i) * D, h);
      }
    }
  }
  h_out[static_cast<long long>(b) * D + d] = h;
}

}  // namespace

extern "C" {

const char* rglru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16 (x, log_a and y alike); h_final float32.
int rglru_scan_fwd(int dtype, const void* x, const void* log_a, void* y,
                   float* h_final, int B, int S, int D, void* stream) {
  if (B < 0 || S < 0 || D < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || D == 0) return 0;
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    rglru_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(log_a),
        static_cast<float*>(y), h_final, S, D);
  else if (dtype == 1)
    rglru_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(log_a),
        static_cast<__nv_bfloat16*>(y), h_final, S, D);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
