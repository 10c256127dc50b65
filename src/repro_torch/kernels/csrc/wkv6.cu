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
// in that type, S_final (B, H, D, D) float32.  Inputs and y are read and
// written through element strides (b, h, t) with a contiguous D axis, so the
// model's (B, S, H, D) projections need no transposing copy.  The TPU kernel
// walks time as its sequential minor grid dimension and keeps the state in
// VMEM scratch across time blocks.  Two kernels, chosen by the wrapper
// (kernels/wkv6.py::_variant); each C entry point launches on the caller's
// stream, allocates nothing and returns cudaGetLastError().
//
// Bound: at the serving shape (B = 4, H = 64, S_len = 512, D = 64, bf16) the
// inputs, y and S_final are ~88 MB (0.026 ms at 3.35 TB/s).  The sequential
// form's ~2.1 GFLOP of state update and read-out take ~0.032 ms on the
// CUDA cores in float32; the chunked form below does ~2.4 GFLOP on the
// tensor cores and ~0.23 GFLOP on the CUDA cores, ~0.006 ms, so for it the
// bytes bind.  With one block per (b, h) there are only 256 blocks, two an
// SM, and each walks 32 chunks in order, so what bounds the kernel in
// practice is a chunk's latency through shared memory, not either rate.
//
// wkv6_chunk_kernel (bfloat16; D = 16, 32, 48 or 64; 16-byte-aligned rows):
// the chunked form of gated linear attention (Yang et al., arXiv:2312.06635),
// in chunks of 16 steps.  Within a chunk starting from state S0, with
// P_t = prod_{tau <= t} w_tau and Q_s = prod_{s < tau < 16} w_tau (products of
// decays within the chunk, per channel, so every factor is at most 1 and
// w = 0 gives an exact 0, with no logarithm to overflow):
//
//   y_t  = (r_t * P_{t-1})^T S0 + sum_{s <= t} A[t][s] v_s
//   A[t][s] = sum_i r_t[i] k_s[i] prod_{s < tau < t} w_tau[i]   (s < t)
//   A[t][t] = sum_i r_t[i] u[i] k_t[i]
//   S_end = diag(P_15) S0 + sum_s (k_s * Q_s) v_s^T
//
// One block of 8 warps owns one (b, h), split into 4 producer and 4
// consumer warps that hand chunks over through double-buffered shared
// memory and named barriers (full / empty per buffer), so that chunk c + 1's
// work on the CUDA cores overlaps chunk c's on the tensor cores.  The
// producers bring a chunk's r, k, v and w in through a ring of two slots
// (16-byte cp.async copies; chunk c + 1 loads while chunk c is worked on),
// then (1) scan each channel's decays, two channels a thread: P builds
// r * P_{t-1} (bf16) and Q builds k * Q_s (float32 split into a bf16 hi
// and lo pair), and the two factors of the scores' cross block (rows
// t >= 8, columns s < 8), referenced to the middle of the chunk,
// r_t * prod_{8 <= tau < t} w and k_s * prod_{s < tau < 8} w, in bf16, both
// products of decays; the P scan also stages r and w as float32, and the
// threads left over copy v for the consumers; and (2) compute the scores
// within each half of the chunk (two 8 x 8 triangles and the diagonal) in
// float32 as running products of w: a thread takes a pair of columns
// s, 7 - s of one half, whose rows add up to 7 steps, times a group of
// channels read 16 bytes at a time; shuffles add a warp's groups and each
// warp stores its own sums.  (3) Consumer warp j, one slice of 16 columns
// of v and of the state, runs on mma.sync
// m16n8k16 (bf16 in, float32 accumulate): the cross block, one product
// over D, and with the state transposed, S^T (16 x D), as its float32
// accumulators, Y^T = S0^T (R~)^T + V^T A^T, where S^T's C fragments
// rounded to bf16 are the A fragments of the read-out as they stand, and
// then S^T <- S^T diag(P_15) + V^T (K~hi + K~lo), so the state never
// leaves float32 registers and its update keeps ~16 bits of each k * Q_s.
// The ragged S_len edge is zero-filled in shared memory (r = k = v = 0),
// with w = 1 in the scans; nothing is padded in device memory.
//
// wkv6_kernel (float32, or bf16 rows the 16-byte copies cannot take): the
// sequential form on the CUDA cores.  One thread block owns one (b, h) and
// keeps the whole state in registers: thread (j, q) holds column j of S,
// rows 16m + 4q + e (q < 4, e < 4), so 4*D threads share the 16 KB state at
// D = 64.  Time runs in chunks of kT steps staged in shared memory as
// float32; every thread steps through them: its share of r^T S and of the
// bonus from float4 reads, the in-place update S = w*S + k*v_j, and two
// shuffles that add the four row groups of column j.

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

// ---------------------------------------------------------------------------
// the chunked kernel (bf16, tensor cores)
// ---------------------------------------------------------------------------

constexpr int kL = 16;               // time steps a chunk
constexpr int kCThreads = 256;       // 4 consumer and 4 producer warps

// as in flash_attention.cu
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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
// two floats as a bf16x2 register, lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

constexpr int kH = kL / 2;           // half a chunk

// Rows of a chunk in the cp.async ring: D + 8 bf16 apart (16 bytes of
// padding, so that ldmatrix phases fall on distinct banks).
template <int kD>
__device__ __forceinline__ int xrow(int t) {
  return t * (kD + 8);
}
// Rows of r and w as float32 for the score loop: D + 4 words apart, and
// rows 8..15 16 words further, so that a quarter warp's 16-byte reads of
// rows t .. t + 3 and t + 8 .. t + 11 fall on 8 distinct bank groups.
template <int kD>
constexpr int kFRows = kL * (kD + 4) + 16;
template <int kD>
__device__ __forceinline__ int frow(int t) {
  return t * (kD + 4) + (t >= kH ? 16 : 0);
}

// two bf16 from shared memory as float32, and two float32 to shared memory
// as bf16 (returning the rounded values)
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 st2(__nv_bfloat16* p, float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  *reinterpret_cast<__nv_bfloat162*>(p) = h;
  return __bfloat1622float2(h);
}

// kM consecutive floats from shared memory, 16 or 8 bytes at a time where
// they can be
template <int kM>
__device__ __forceinline__ void load_ch(const float* p, float (&v)[kM]) {
  if constexpr (kM == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else if constexpr (kM == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x, v[1] = x.y;
  } else {
#pragma unroll
    for (int m = 0; m < kM; ++m) v[m] = p[m];
  }
}

// ldmatrix of two 8x8 tiles (addresses from lanes 0-15)
__device__ __forceinline__ void ldsm_x2(unsigned* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// kM consecutive bf16 from shared memory as float32, two at a time for an
// even kM (p is then 4-byte aligned: it starts at channel kM * cg)
template <int kM>
__device__ __forceinline__ void load_bf(const __nv_bfloat16* p,
                                        float (&v)[kM]) {
  if constexpr (kM % 2 == 0) {
#pragma unroll
    for (int m = 0; m < kM; m += 2) {
      const float2 x = ld2(p + m);
      v[m] = x.x, v[m + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int m = 0; m < kM; ++m) v[m] = __bfloat162float(p[m]);
  }
}

// Shared memory of one block.  The ring and r32, w32 are the producers'
// own; what they hand the consumers is double-buffered by chunk parity.
template <int kD>
struct ChunkSmem {
  __nv_bfloat16 x[2][4][kL * (kD + 8)];  // ring: r, k, v, w rows at xrow(t)
  float r32[kFRows<kD>];               // r as float32, rows at frow(t)
  float w32[kFRows<kD>];               // w as float32 (1 past S_len)
  __nv_bfloat16 v[2][kL][kD + 8];      // v
  float a[2][4][kL][kL + 2];           // scores A[t][s], a sum per warp
  __nv_bfloat16 rt[2][kL][kD + 8];     // r_t * P_{t-1}
  __nv_bfloat16 rh[2][kH][kD + 8];     // r_t * prod_{8 <= tau < t} w, t >= 8
  __nv_bfloat16 kd[2][kH][kD + 8];     // k_s * prod_{s < tau < 8} w, s < 8
  __nv_bfloat16 kh[2][kL][kD + 8];     // k_s * Q_s, rounded to bf16
  __nv_bfloat16 kl[2][kL][kD + 8];     // ... and what that rounding lost
  float p_last[2][kD];                 // P_15: the chunk's decay of S
  __nv_bfloat16 ys[kL][kD + 8];        // y rows, for 16-byte stores
};

// named barriers: kFull + b (buffer b holds a chunk), kEmpty + b (buffer
// b consumed), kProd (the producers alone); 0 is __syncthreads
constexpr int kFull = 1, kEmpty = 3, kProd = 5;
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

template <int kD>
__global__ void __launch_bounds__(kCThreads, 2) wkv6_chunk_kernel(Args a) {
  constexpr int kM = kD / 16;   // channels a thread takes in the score loop
  constexpr int kNT = kD / 8;   // n-tiles of 8 state rows
  constexpr int kVec = kD / 8;  // 16-byte pieces of a row
  constexpr int kHalf = kCThreads / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChunkSmem<kD>& sm = *reinterpret_cast<ChunkSmem<kD>*>(smem_raw);
  using bf16 = __nv_bfloat16;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.y;
  const int n_chunks = (a.S + kL - 1) / kL;
  // the entries s > t of each warp's scores stay 0
  for (int i = tid; i < 2 * 4 * kL * (kL + 2); i += kCThreads)
    (&sm.a[0][0][0][0])[i] = 0.f;
  __syncthreads();

  if (tid >= kHalf) {
    // ---- producers, warps 4-7: the ring, the decay products and the
    // scores within each half of a chunk, on the CUDA cores ----
    const int pt = tid - kHalf, pw = pt >> 5, mi = lane >> 3;
    const bf16* src[4] = {
        static_cast<const bf16*>(a.r) + b * a.r_sb + h * a.r_sh,
        static_cast<const bf16*>(a.k) + b * a.k_sb + h * a.k_sh,
        static_cast<const bf16*>(a.v) + b * a.v_sb + h * a.v_sh,
        static_cast<const bf16*>(a.w) + b * a.w_sb + h * a.w_sh};
    const long long ss[4] = {a.r_ss, a.k_ss, a.v_ss, a.w_ss};
    // chunk c into ring slot c % 2
    auto stage = [&](int c) {
      const int t0 = c * kL;
#pragma unroll
      for (int arr = 0; arr < 4; ++arr)
        for (int i = pt; i < kL * kVec; i += kHalf) {
          const int r = i / kVec, col = 8 * (i % kVec);
          const bool ok = t0 + r < a.S;
          cp_async16(&sm.x[c & 1][arr][xrow<kD>(r) + col],
                     ok ? src[arr] + (t0 + r) * ss[arr] + col : src[arr], ok);
        }
      cp_async_commit();
    };
    // thread (pair p, channel group cg) takes, in the half h0 = 8 (p / 4)
    // of the chunk, columns s1 = h0 + p % 4 and s2 = h0 + 7 - p % 4 of A,
    // and channels kM cg .. kM cg + kM - 1.  Rows past S_len hold r = 0, so
    // they add nothing, whatever w they hold.
    const int p = pt & 7, cg = pt >> 3, pp = p & 3, h0 = kH * (p >> 2);
    const int s1 = h0 + pp, s2 = h0 + kH - 1 - pp, c0 = kM * cg;
    float uu[kM];
#pragma unroll
    for (int m = 0; m < kM; ++m)
      uu[m] = __bfloat162float(static_cast<const bf16*>(a.u)[h * kD + c0 + m]);

    if (n_chunks > 0) stage(0);
    for (int c = 0; c < n_chunks; ++c) {
      const int buf = c & 1;
      cp_async_wait_all();
      bar_sync(kProd, kHalf);  // chunk c landed; chunk c - 1 is read
      if (c + 1 < n_chunks) stage(c + 1);
      const int n = min(kL, a.S - c * kL);
      const bf16* xr = sm.x[buf][0];
      const bf16* xk = sm.x[buf][1];
      const bf16* xv = sm.x[buf][2];
      const bf16* xw = sm.x[buf][3];
      if (c >= 2) bar_sync(kEmpty + buf, kCThreads);  // chunk c - 2 consumed
      // (1) column scans, two channels a thread: P (forward) builds r~ and
      // the cross block's row factor, Q (backward) builds k~ and its column
      // factor; the other threads copy v
      if (pt < kD / 2) {
        const int i = 2 * pt;
        float2 pr = make_float2(1.f, 1.f), ph = pr;
#pragma unroll
        for (int t = 0; t < kL; ++t) {
          const float2 wt = t < n ? ld2(xw + xrow<kD>(t) + i)
                                  : make_float2(1.f, 1.f);
          const float2 rt = ld2(xr + xrow<kD>(t) + i);
          *reinterpret_cast<float2*>(&sm.w32[frow<kD>(t) + i]) = wt;
          *reinterpret_cast<float2*>(&sm.r32[frow<kD>(t) + i]) = rt;
          st2(&sm.rt[buf][t][i], rt.x * pr.x, rt.y * pr.y);
          pr.x *= wt.x;
          pr.y *= wt.y;
          if (t >= kH) {
            st2(&sm.rh[buf][t - kH][i], rt.x * ph.x, rt.y * ph.y);
            ph.x *= wt.x;
            ph.y *= wt.y;
          }
        }
        *reinterpret_cast<float2*>(&sm.p_last[buf][i]) = pr;
      } else if (pt < kD) {
        const int i = 2 * pt - kD;
        float2 qs = make_float2(1.f, 1.f), qh = qs;
#pragma unroll
        for (int t = kL - 1; t >= 0; --t) {
          const float2 kt = ld2(xk + xrow<kD>(t) + i);
          const float2 wt = t < n ? ld2(xw + xrow<kD>(t) + i)
                                  : make_float2(1.f, 1.f);
          const float2 x = make_float2(kt.x * qs.x, kt.y * qs.y);
          const float2 hi = st2(&sm.kh[buf][t][i], x.x, x.y);
          st2(&sm.kl[buf][t][i], x.x - hi.x, x.y - hi.y);
          qs.x *= wt.x;
          qs.y *= wt.y;
          if (t < kH) {
            st2(&sm.kd[buf][t][i], kt.x * qh.x, kt.y * qh.y);
            qh.x *= wt.x;
            qh.y *= wt.y;
          }
        }
      } else {
        for (int j = pt - kD; j < kL * kVec; j += kHalf - kD) {
          const int r = j / kVec, col = 8 * (j % kVec);
          *reinterpret_cast<int4*>(&sm.v[buf][r][col]) =
              *reinterpret_cast<const int4*>(xv + xrow<kD>(r) + col);
        }
      }
      bar_sync(kProd, kHalf);  // r32 and w32 written

      // (2) the scores within each half of the chunk
      float k1[kM], k2[kM], e[kM], x[kM];
      float d1 = 0.f, d2 = 0.f;
      load_bf<kM>(xk + xrow<kD>(s1) + c0, k1);
      load_bf<kM>(xk + xrow<kD>(s2) + c0, k2);
      load_ch<kM>(&sm.r32[frow<kD>(s1) + c0], x);
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        e[m] = 1.f;
        d1 = fmaf(x[m] * uu[m], k1[m], d1);
      }
      load_ch<kM>(&sm.r32[frow<kD>(s2) + c0], x);
#pragma unroll
      for (int m = 0; m < kM; ++m) d2 = fmaf(x[m] * uu[m], k2[m], d2);
      // step it: column s1 at row s1 + 1 + it, then, from it = 7 - pp on,
      // column s2 at row h0 + 1 + it; e is prod_{s < tau < t} w_tau.  The
      // sums stay in registers until the loop ends, so that nothing orders
      // the steps' shared-memory reads.
      float acc[kH - 1];
#pragma unroll
      for (int it = 0; it < kH - 1; ++it) {
        const bool second = it >= kH - 1 - pp;
        const bool reset = it == kH - 1 - pp;
        const int t = second ? h0 + 1 + it : s1 + 1 + it;
        float wv[kM];
        load_ch<kM>(&sm.r32[frow<kD>(t) + c0], x);
        load_ch<kM>(&sm.w32[frow<kD>(t) + c0], wv);
        acc[it] = 0.f;
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          if (reset) e[m] = 1.f;
          acc[it] = fmaf(x[m] * (second ? k2[m] : k1[m]), e[m], acc[it]);
          e[m] *= wv[m];
        }
      }
      // add the warp's four channel groups; lanes 0-7 store the warp's sums
      d1 += __shfl_xor_sync(0xffffffffu, d1, 8);
      d2 += __shfl_xor_sync(0xffffffffu, d2, 8);
#pragma unroll
      for (int it = 0; it < kH - 1; ++it)
        acc[it] += __shfl_xor_sync(0xffffffffu, acc[it], 8);
      d1 += __shfl_xor_sync(0xffffffffu, d1, 16);
      d2 += __shfl_xor_sync(0xffffffffu, d2, 16);
#pragma unroll
      for (int it = 0; it < kH - 1; ++it)
        acc[it] += __shfl_xor_sync(0xffffffffu, acc[it], 16);
      if (mi == 0) {
        float(*aw)[kL + 2] = sm.a[buf][pw];
        aw[s1][s1] = d1;
        aw[s2][s2] = d2;
#pragma unroll
        for (int it = 0; it < kH - 1; ++it) {
          const bool second = it >= kH - 1 - pp;
          aw[second ? h0 + 1 + it : s1 + 1 + it][second ? s2 : s1] = acc[it];
        }
      }
      bar_arrive(kFull + buf, kCThreads);  // chunk c is ready
    }
    return;
  }

  // ---- consumers, warps 0-3: warp w < kD / 16 owns columns j0 .. j0 + 15
  // of v and of the state, held as S^T (16 x kD) in m16n8 C fragments, on
  // the tensor cores ----
  const int g = lane >> 2, q = lane & 3, mi = lane >> 3, mr = lane & 7;
  const bool state_warp = warp < kD / 16;
  const int j0 = 16 * warp;
  bf16* y = static_cast<bf16*>(a.y) + b * a.y_sb + h * a.y_sh;
  float st[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
    st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kL, n = min(kL, a.S - t0), buf = c & 1;
    bar_sync(kFull + buf, kCThreads);  // chunk c is ready

    if (state_warp) {
      unsigned va[4];  // V^T (16 j x 16 s) as an A fragment
      ldsm_x4_trans(va, &sm.v[buf][mr + 8 * (mi >> 1)][j0 + 8 * (mi & 1)]);
      // the cross block A[8 + g][s < 8] = (R^h K^d^T)[g][s] (rows 8-15 of
      // the tile repeat rows 0-7 and are not used)
      float ac[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kt = 0; kt < kD / 16; ++kt) {
        unsigned ra[4], kb[2];
        ldsm_x4(ra, &sm.rh[buf][mr][16 * kt + 8 * (mi >> 1)]);
        ldsm_x2(kb, &sm.kd[buf][mr][16 * kt + 8 * (mi & 1)]);
        mma_bf16(ac, ra, kb[0], kb[1]);
      }
      float yt[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      // Y^T = S0^T (R~)^T: S^T's C fragments are the A fragments
#pragma unroll
      for (int kt = 0; kt < kD / 16; ++kt) {
        const unsigned sa[4] = {
            pack_bf16(st[2 * kt][0], st[2 * kt][1]),
            pack_bf16(st[2 * kt][2], st[2 * kt][3]),
            pack_bf16(st[2 * kt + 1][0], st[2 * kt + 1][1]),
            pack_bf16(st[2 * kt + 1][2], st[2 * kt + 1][3])};
        unsigned rb[4];
        ldsm_x4(rb, &sm.rt[buf][mr + 8 * (mi >> 1)][16 * kt + 8 * (mi & 1)]);
        mma_bf16(yt[0], sa, rb[0], rb[1]);
        mma_bf16(yt[1], sa, rb[2], rb[3]);
      }
      // ... + V^T A^T, A summed over the producer warps
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float2 lo = nt ? make_float2(ac[0], ac[1]) : make_float2(0.f, 0.f);
        float2 hi = make_float2(0.f, 0.f);
#pragma unroll
        for (int w4 = 0; w4 < 4; ++w4) {
          const float* ar = sm.a[buf][w4][g + 8 * nt];
          const float2 x0 = *reinterpret_cast<const float2*>(ar + 2 * q);
          const float2 x1 = *reinterpret_cast<const float2*>(ar + 2 * q + 8);
          lo.x += x0.x;
          lo.y += x0.y;
          hi.x += x1.x;
          hi.y += x1.y;
        }
        mma_bf16(yt[nt], va, pack_bf16(lo.x, lo.y), pack_bf16(hi.x, hi.y));
      }
      // S^T <- S^T diag(P_15) + V^T (K~hi + K~lo)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const float2 pl =
            *reinterpret_cast<const float2*>(&sm.p_last[buf][8 * nt + 2 * q]);
        st[nt][0] *= pl.x;
        st[nt][1] *= pl.y;
        st[nt][2] *= pl.x;
        st[nt][3] *= pl.y;
      }
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        const int s = mr + 8 * (mi & 1), i = 8 * (2 * np + (mi >> 1));
        unsigned bh[4], bl[4];
        ldsm_x4_trans(bh, &sm.kh[buf][s][i]);
        ldsm_x4_trans(bl, &sm.kl[buf][s][i]);
        mma_bf16(st[2 * np], va, bh[0], bh[1]);
        mma_bf16(st[2 * np], va, bl[0], bl[1]);
        mma_bf16(st[2 * np + 1], va, bh[2], bh[3]);
        mma_bf16(st[2 * np + 1], va, bl[2], bl[3]);
      }
      // buffer buf read: the producers may refill it
      if (c + 2 < n_chunks) bar_arrive(kEmpty + buf, kCThreads);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int t = 8 * nt + 2 * q;
        sm.ys[t][j0 + g] = __float2bfloat16(yt[nt][0]);
        sm.ys[t + 1][j0 + g] = __float2bfloat16(yt[nt][1]);
        sm.ys[t][j0 + g + 8] = __float2bfloat16(yt[nt][2]);
        sm.ys[t + 1][j0 + g + 8] = __float2bfloat16(yt[nt][3]);
      }
      __syncwarp();
      const int row = lane >> 1, col = j0 + 8 * (lane & 1);
      if (row < n)
        *reinterpret_cast<int4*>(y + (t0 + row) * a.y_ss + col) =
            *reinterpret_cast<const int4*>(&sm.ys[row][col]);
      __syncwarp();  // the stores read ys before the next chunk writes it
    } else if (c + 2 < n_chunks) {
      bar_arrive(kEmpty + buf, kCThreads);
    }
  }

  if (state_warp) {  // S[i][j] = S^T[j][i]
    float* sf = a.s_final + (static_cast<long long>(b) * a.H + h) * kD * kD;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int i = 8 * nt + 2 * q, j = j0 + g;
      sf[i * kD + j] = st[nt][0];
      sf[(i + 1) * kD + j] = st[nt][1];
      sf[i * kD + j + 8] = st[nt][2];
      sf[(i + 1) * kD + j + 8] = st[nt][3];
    }
  }
}

template <int kD>
cudaError_t launch_chunked(const Args& a, int B, cudaStream_t s) {
  constexpr int kSmem = sizeof(ChunkSmem<kD>);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_chunk_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  wkv6_chunk_kernel<kD><<<dim3(a.H, B), kCThreads, kSmem, s>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_chunked(const Args& a, int B, int D, cudaStream_t s) {
  switch (D) {
    case 16: return launch_chunked<16>(a, B, s);
    case 32: return launch_chunked<32>(a, B, s);
    case 48: return launch_chunked<48>(a, B, s);
    case 64: return launch_chunked<64>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
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

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w, u and y alike);
// chunked != 0: the chunked tensor-core kernel (bfloat16 only, every row
// and base 16-byte aligned).
int wkv6_fwd(int dtype, int chunked, const void* r, const void* k,
             const void* v, const void* w, const void* u, void* y,
             float* s_final, int B, int H, int S, int D, long long r_sb,
             long long r_sh, long long r_ss, long long k_sb, long long k_sh,
             long long k_ss, long long v_sb, long long v_sh, long long v_ss,
             long long w_sb, long long w_sh, long long w_ss, long long y_sb,
             long long y_sh, long long y_ss, void* stream) {
  if (D % 16 != 0 || D < 16 || D > 64 || B < 0 || H < 0 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  const Args a{r,    k,    v,    w,    u,    y,    s_final, H,    S,
               r_sb, r_sh, r_ss, k_sb, k_sh, k_ss, v_sb,    v_sh, v_ss,
               w_sb, w_sh, w_ss, y_sb, y_sh, y_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunked) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_chunked(a, B, D, s));
  }
  if (dtype == 0) return static_cast<int>(launch<float>(a, B, D, s));
  if (dtype == 1) return static_cast<int>(launch<__nv_bfloat16>(a, B, D, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
