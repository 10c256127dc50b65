// Flash attention (prefill / full-sequence forward), hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel flash_attention (_attn_kernel) of
// src/repro/kernels/flash_attention.py.  For q (B, Hq, Sq, D) and k, v
// (B, Hkv, Sk, D), Hq % Hkv == 0, query head h reading kv head h / (Hq/Hkv):
//
//   out[b,h,i] = sum_j softmax_j(scale * q[b,h,i] . k[b,hk,j]) v[b,hk,j]
//
// over the keys j the masks leave visible: j < kv_limit, and with `causal`
// j <= i + offset, and with a window w > 0 also j > i + offset - w.  A row
// with no visible key is zeros (the Pallas kernel's l == 0 -> l_safe = 1).
// Scores, the online-softmax statistics (m, l) and the PV accumulator are
// float32; the output is cast to the input type once.
//
// Where the TPU kernel walks the key blocks as a sequential grid dimension and
// carries (m, l, acc) in VMEM scratch, here one thread block owns one
// (b, h, 64-row query tile) and loops over 64-key tiles itself.  Q, K and V
// tiles are staged in shared memory as float32 (Q and K transposed, so the
// score loop reads 16-byte vectors without bank conflicts); each of the 256
// threads holds a 4x4 block of scores and a 4 x (DMax/16) block of the
// output rows.  The kernel is templated on the head-dimension cap DMax: 128
// (D <= 128, 117 KB of shared memory, 4x8 outputs a thread) or 256 (D <= 256,
// as recurrentgemma's local attention: 222,208 B of the 232,448 a block may
// use, 4x16 outputs a thread, one block per SM).
// Tiles wholly above the causal diagonal, wholly outside the window or past
// kv_limit are skipped: they contribute nothing.
//
// Bound: at the serving path's prefill shapes (D = 128, Sq = Sk = 512) the
// work is operations (~4*B*Hq*Sq*Sk*D/2 FLOP, causal), far above the card's
// ridge point.  This first kernel runs them on the CUDA cores in float32 (it
// also serves float32 models); tensor-core MMA, TMA and warp specialisation
// are left to a later change.  Strided inputs (element strides, D
// contiguous) are read in place, so the caller's (B, S, H, D) projections
// need no transposing copy.  The C entry point launches on the caller's
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kQS = kBQ + 4;   // shared-memory row strides, in floats
constexpr int kKS = kBK + 4;
constexpr int kPS = kBQ + 4;
constexpr float kNegInf = -1e30f;

// shared memory of the kernel for head dimensions up to kDMax
constexpr size_t smem_bytes(int kDMax) {
  return sizeof(float) * (kDMax * kQS + kDMax * kKS + kBK * kDMax + kBK * kPS);
}

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
  void* o;
  int B, Hq, Hkv, Sq, Sk, D;
  long long q_sb, q_sh, q_ss;  // element strides; the D axis is contiguous
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  float scale;
  int causal, window, kv_limit, offset;
};

template <typename T, int kDMax>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  constexpr int kCols = kDMax / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                // [kDMax][kQS]  q tile, transposed
  float* Kt = Qt + kDMax * kQS;    // [kDMax][kKS]  k tile, transposed
  float* Vs = Kt + kDMax * kKS;    // [kBK][kDMax]  v tile (zero past D)
  float* Pt = Vs + kBK * kDMax;    // [kBK][kPS]    probabilities, transposed

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // score columns tx*4.., output columns 64*g+tx*4..
  const int ty = tid >> 4;   // rows ty*4 .. ty*4+3
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int D = a.D;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int qi = q0 + r;
    Qt[d * kQS + r] = qi < a.Sq ? to_f(q[qi * a.q_ss + d]) : 0.f;
  }

  // the key range any row of this tile can see
  const int q_last = min(q0 + kBQ, a.Sq) - 1;
  int k_end = a.kv_limit;
  if (a.causal) k_end = min(k_end, q_last + a.offset + 1);
  int k_begin = 0;
  if (a.window > 0) k_begin = max(0, q0 + a.offset - a.window + 1);
  k_begin = (k_begin / kBK) * kBK;

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      const int j = k0 + r;
      Kt[d * kKS + r] = j < a.Sk ? to_f(k[j * a.k_ss + d]) : 0.f;
    }
    for (int i = tid; i < kBK * kDMax; i += kThreads) {
      const int r = i / kDMax, d = i - r * kDMax;
      const int j = k0 + r;
      Vs[i] = (j < a.Sk && d < D) ? to_f(v[j * a.v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(Qt + d * kQS + ty * 4);
      const float4 kb = *reinterpret_cast<const float4*>(Kt + d * kKS + tx * 4);
      const float qr[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kc[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qr[r], kc[c], s[r][c]);
    }

    // masks, then the online softmax; a row's 16 column threads are 16
    // neighbouring lanes of one warp, so shuffles reduce across them
    bool vis[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + ty * 4 + r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + tx * 4 + c;
        bool ok = j < a.kv_limit;
        if (a.causal) ok = ok && j <= i + a.offset;
        if (a.window > 0) ok = ok && j > i + a.offset - a.window;
        vis[r][c] = ok;
        s[r][c] = ok ? s[r][c] * a.scale : kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = vis[r][c] ? expf(s[r][c] - m_new) : 0.f;
        sum += p;
        Pt[(tx * 4 + c) * kPS + ty * 4 + r] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();

    for (int kk = 0; kk < kBK; ++kk) {
      const float4 pp = *reinterpret_cast<const float4*>(Pt + kk * kPS + ty * 4);
      const float pr[4] = {pp.x, pp.y, pp.z, pp.w};
      float vc[kCols];
#pragma unroll
      for (int g = 0; g < kCols / 4; ++g) {
        const float4 vg = *reinterpret_cast<const float4*>(
            Vs + kk * kDMax + 64 * g + tx * 4);
        vc[4 * g] = vg.x;
        vc[4 * g + 1] = vg.y;
        vc[4 * g + 2] = vg.z;
        vc[4 * g + 3] = vg.w;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[r][c] = fmaf(pr[r], vc[c], acc[r][c]);
    }
  }

  T* o = static_cast<T*>(a.o) + (static_cast<long long>(b) * a.Hq + h) *
                                    static_cast<long long>(a.Sq) * D;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty * 4 + r;
    if (i >= a.Sq) continue;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = 64 * (c / 4) + tx * 4 + (c & 3);
      if (col < D) store(o + static_cast<long long>(i) * D + col,
                         acc[r][c] / l_safe);
    }
  }
}

template <typename T, int kDMax>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t kSmemBytes = smem_bytes(kDMax);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, kDMax>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.Hq, a.B);
  flash_fwd_kernel<T, kDMax><<<grid, kThreads, kSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  return a.D <= 128 ? launch<T, 128>(a, stream) : launch<T, 256>(a, stream);
}

}  // namespace

extern "C" {

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike).
int flash_attention_fwd(int dtype, const void* q, const void* k,
                        const void* v, void* out, int B, int Hq, int Hkv,
                        int Sq, int Sk, int D, long long q_sb, long long q_sh,
                        long long q_ss, long long k_sb, long long k_sh,
                        long long k_ss, long long v_sb, long long v_sh,
                        long long v_ss, float scale, int causal, int window,
                        int kv_limit, int offset, void* stream) {
  if (D < 1 || D > 256 || Hkv < 1 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0 || Hq == 0) return 0;
  const Args a{q,    k,    v,    out,  B,     Hq,     Hkv,    Sq,
               Sk,   D,    q_sb, q_sh, q_ss,  k_sb,   k_sh,   k_ss,
               v_sb, v_sh, v_ss, scale, causal, window, kv_limit, offset};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(dispatch<float>(a, s));
  if (dtype == 1) return static_cast<int>(dispatch<__nv_bfloat16>(a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
