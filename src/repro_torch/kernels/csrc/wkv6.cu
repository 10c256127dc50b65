// RWKV-6 (Finch) WKV recurrence, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel wkv6 (_wkv6_kernel) of
// src/repro/kernels/wkv6.py.  Per (b, h), with a D x D float32 state S that
// starts at zero, for t = 0 .. S_len-1:
//
//   y_t = r_t^T S_{t-1} + (sum_i r_t[i] u[i] k_t[i]) v_t
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// r, k, v, w (B, H, S_len, D) and u (H, D) in one type; y (B, H, S_len, D)
// in that type, S_final (B, H, D, D) float32.
//
// The TPU kernel walks time as its sequential minor grid dimension and keeps
// the state in VMEM scratch across time blocks.  Here one thread block owns
// one (b, h) and keeps the whole state on chip for the whole sequence, in
// registers: thread (j, q) holds column j of S, rows 16m + 4q + e (q < 4,
// e < 4), so 4*D threads share the 16 KB state at D = 64 and each holds D/4
// values.  Time runs in chunks of kT steps: the block stages a chunk's r, k,
// v and w in shared memory as float32 (coalesced rows of D), then every
// thread steps through it with no further global load: its share of r^T S
// and of the bonus sum from float4 reads of r, k and w, the in-place update
// S = w*S + k*v_j, and two shuffles that add the four row groups of column
// j.  The ragged S_len edge is masked here; nothing is padded in memory.
//
// Bound: at the serving shape (B = 4, H = 64, S_len = 512, D = 64, bf16) the
// inputs, y and S_final are ~88 MB (0.026 ms at 3.35 TB/s) and the ~2.1
// GFLOP of state update and read-out take ~0.032 ms on the CUDA cores in
// float32, so operations bound it.  The grid is B*H = 256 blocks of 256
// threads, about two blocks per SM; the time loop is sequential by nature.
// Inputs and y are read and written through element strides (b, h, t) with
// a contiguous D axis, so the model's (B, S, H, D) projections need no
// transposing copy.  The C entry point launches on the caller's stream,
// allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSplit = 4;  // threads per state column
constexpr int kT = 32;     // time steps staged per chunk

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const void* u;
  void* y;
  float* s_final;
  int H, S;
  long long r_sb, r_sh, r_ss;  // element strides; the D axis is contiguous
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long w_sb, w_sh, w_ss;
  long long y_sb, y_sh, y_ss;
};

template <typename T, int kD>
__global__ void __launch_bounds__(kD * kSplit) wkv6_kernel(Args a) {
  constexpr int kThreads = kD * kSplit;
  constexpr int kVec = kD / 16;  // float4 groups of rows per thread
  constexpr int kRows = 4 * kVec;
  __shared__ __align__(16) float rs[kT][kD];
  __shared__ __align__(16) float ks[kT][kD];
  __shared__ __align__(16) float ws[kT][kD];
  __shared__ __align__(16) float vs[kT][kD];

  const int tid = threadIdx.x;
  const int j = tid / kSplit;  // state column
  const int q = tid % kSplit;  // row group
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const T* r = static_cast<const T*>(a.r) + b * a.r_sb + h * a.r_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const T* w = static_cast<const T*>(a.w) + b * a.w_sb + h * a.w_sh;
  const T* u = static_cast<const T*>(a.u) + static_cast<long long>(h) * kD;
  T* y = static_cast<T*>(a.y) + b * a.y_sb + h * a.y_sh;

  float st[kRows], ur[kRows];
#pragma unroll
  for (int m = 0; m < kVec; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      st[4 * m + e] = 0.f;
      ur[4 * m + e] = to_f(u[16 * m + 4 * q + e]);
    }

  for (int t0 = 0; t0 < a.S; t0 += kT) {
    const int n = min(kT, a.S - t0);
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < kT * kD; i += kThreads) {
      const int tt = i / kD, d = i - tt * kD;
      const bool ok = tt < n;
      const long long t = t0 + tt;
      rs[tt][d] = ok ? to_f(r[t * a.r_ss + d]) : 0.f;
      ks[tt][d] = ok ? to_f(k[t * a.k_ss + d]) : 0.f;
      vs[tt][d] = ok ? to_f(v[t * a.v_ss + d]) : 0.f;
      ws[tt][d] = ok ? to_f(w[t * a.w_ss + d]) : 0.f;
    }
    __syncthreads();

    for (int tt = 0; tt < n; ++tt) {
      const float vj = vs[tt][j];
      float part = 0.f, bonus = 0.f;
#pragma unroll
      for (int m = 0; m < kVec; ++m) {
        const int i0 = 16 * m + 4 * q;
        const float4 r4 = *reinterpret_cast<const float4*>(&rs[tt][i0]);
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[tt][i0]);
        const float4 w4 = *reinterpret_cast<const float4*>(&ws[tt][i0]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& s = st[4 * m + e];
          part = fmaf(rr[e], s, part);
          bonus = fmaf(rr[e] * ur[4 * m + e], kk[e], bonus);
          s = fmaf(ww[e], s, kk[e] * vj);
        }
      }
      part = fmaf(bonus, vj, part);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      if (q == 0) store(y + (t0 + tt) * a.y_ss + j, part);
    }
  }

  float* sf = a.s_final +
              (static_cast<long long>(b) * a.H + h) * kD * static_cast<long long>(kD);
#pragma unroll
  for (int m = 0; m < kVec; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sf[static_cast<long long>(16 * m + 4 * q + e) * kD + j] = st[4 * m + e];
}

template <typename T>
cudaError_t launch(const Args& a, int B, int D, cudaStream_t s) {
  const dim3 grid(a.H, B);
  switch (D) {
    case 16: wkv6_kernel<T, 16><<<grid, 16 * kSplit, 0, s>>>(a); break;
    case 32: wkv6_kernel<T, 32><<<grid, 32 * kSplit, 0, s>>>(a); break;
    case 48: wkv6_kernel<T, 48><<<grid, 48 * kSplit, 0, s>>>(a); break;
    case 64: wkv6_kernel<T, 64><<<grid, 64 * kSplit, 0, s>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w, u and y alike).
int wkv6_fwd(int dtype, const void* r, const void* k, const void* v,
             const void* w, const void* u, void* y, float* s_final, int B,
             int H, int S, int D, long long r_sb, long long r_sh,
             long long r_ss, long long k_sb, long long k_sh, long long k_ss,
             long long v_sb, long long v_sh, long long v_ss, long long w_sb,
             long long w_sh, long long w_ss, long long y_sb, long long y_sh,
             long long y_ss, void* stream) {
  if (D % 16 != 0 || D < 16 || D > 64 || B < 0 || H < 0 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  const Args a{r,    k,    v,    w,    u,    y,    s_final, H,    S,
               r_sb, r_sh, r_ss, k_sb, k_sh, k_ss, v_sb,    v_sh, v_ss,
               w_sb, w_sh, w_ss, y_sb, y_sh, y_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(a, B, D, s));
  if (dtype == 1) return static_cast<int>(launch<__nv_bfloat16>(a, B, D, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
