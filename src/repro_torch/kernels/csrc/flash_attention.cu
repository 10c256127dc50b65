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
// Where the TPU kernel walks the key blocks as a sequential grid dimension and
// carries (m, l, acc) in VMEM scratch, here one thread block owns one
// (b, h, 64-row query tile) and loops over 64-key tiles itself.  Tiles wholly
// above the causal diagonal, wholly outside the window or past kv_limit are
// skipped: they contribute nothing.  Strided inputs (element strides, D
// contiguous) are read in place, so the caller's (B, S, H, D) projections
// need no transposing copy.  Each C entry point launches on the caller's
// stream, allocates nothing and returns cudaGetLastError().
//
// Training: given a non-null `lse` (B, Hq, Sq) float32, both kernels also
// write each row's log-sum-exp, the natural log over the scaled scores
// after the mask, lse = m + log(l) (-1e30 for a row with no visible key),
// as repro/models/flash_xla.py::_fwd_scan returns it; the backward
// (flash_attention_bwd.cu) recomputes the probabilities from it.  Serving
// passes null and nothing is written.
//
// Bound: at the serving paths' prefill shapes the work is operations
// (~4*B*Hq*D FLOP per visible (query, key) pair), far above the card's ridge
// point.  Two kernels, chosen by the wrapper from dtype, D and alignment:
//
// flash_fwd_mma_kernel (bfloat16, D % 8 == 0, 16-byte-aligned rows), the
// layout of FlashAttention-2 on the tensor cores: 4 warps, each owning 16 of
// the tile's 64 query rows.  Q is staged once in shared memory as bf16; K and
// V tiles of 64 keys (32 at D = 256, where a 64-key S and P beside O's 128
// float32 accumulators spill registers; the smaller ring also fits two
// blocks on an SM; 48 at D = 192, MLA's prefill, where 64 keys spill and 48
// keep 244 registers) come in through a 2-stage cp.async ring (16-byte
// copies),
// so tile t+1 loads while tile t computes.  Shared rows are padded by 16
// bytes, which makes every ldmatrix phase hit 8 distinct bank groups.
// S = Q.K^T runs on mma.sync m16n8k16 (bf16 in, float32 accumulate) with
// fragments from ldmatrix; the online softmax (m, l) stays in registers,
// reduced across the 4 lanes that share a row; P is rounded to bf16 in
// registers and is the A operand of the PV mma as it stands (the C layout of
// m16n8 is the A layout of m16k16), V's B fragments come from ldmatrix.trans,
// and O accumulates in float32 registers, rescaled per tile.  Masks are
// applied in registers, only on tiles that cross the diagonal, the window
// edge or kv_limit; the query tiles with the most keys start first.
// Templated on D up to 64, 128, 192 or 256; a D in between is zero-filled
// up to the template in shared memory.  Numerics: P is rounded to
// bf16 before the PV product (the Pallas kernel keeps it float32), and l sums
// the rounded values, so each output is a convex combination of V's rows.
//
// flash_fwd_kernel (float32, or bf16 rows the 16-byte copies cannot take):
// scores, the softmax and PV on the CUDA cores in float32, exact to the
// plain version's rounding (no TF32).  Q, K and V tiles are staged in shared
// memory as float32 (Q and K transposed, so the score loop reads 16-byte
// vectors without bank conflicts); each of the 256 threads holds a 4x4 block
// of scores and a 4 x (DMax/16) block of the output rows.  Templated on DMax
// 128 (117 KB of shared memory) or 256 (222,208 B, one block per SM).

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
  float* lse;  // (B, Hq, Sq) or null
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
    if (a.lse != nullptr && tx == 0)
      a.lse[(static_cast<long long>(b) * a.Hq + h) * a.Sq + i] =
          m[r] + logf(l_safe);
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


// ---------------------------------------------------------------------------
// the tensor-core kernel (bfloat16)
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps x 16 of the kBQ query rows

// shared-memory row stride in bf16 elements (16 bytes of padding) and the
// kernel's dynamic shared memory: the kBQ-row Q tile, then two stages of K
// and of V tiles of kKT keys
template <int kDP>
__host__ __device__ constexpr int row_stride() { return kDP + 8; }
template <int kDP, int kKT>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (kBQ + 4 * kKT) * row_stride<kDP>();
}

// 2^x by the SFU's approximation (relative error ~2^-22, far below the bf16
// rounding of P that follows)
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

// two floats as a bf16x2 register (lo in the low half), and back
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi,
                                              float& lo_r, float& hi_r) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  lo_r = __low2float(h);
  hi_r = __high2float(h);
  return *reinterpret_cast<const unsigned*>(&h);
}

// rows [row0, row0 + kRows) of a (rows, D) bf16 matrix with row stride `ss`
// into a kRows x kDP shared tile; rows past n_rows and columns past D are
// zeros
template <int kDP, int kRows>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long ss, int row0, int n_rows,
                                           int D, int tid) {
  constexpr int kChunks = kDP / 8;  // 16-byte chunks per row
#pragma unroll
  for (int it = 0; it < kRows * kChunks / kMmaThreads; ++it) {
    const int i = tid + it * kMmaThreads;
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = row0 + r < n_rows && c * 8 < D;
    cp_async16(dst + r * row_stride<kDP>() + c * 8,
               ok ? src + (row0 + r) * ss + c * 8 : src, ok);
  }
}

// kKT keys a tile: 64, or 32 at kDP = 256 and 48 at kDP = 192, where S and P
// of a 64-key tile would push the float32 accumulators of O into spills
template <int kDP, int kKT>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_mma_kernel(Args a) {
  constexpr int kS = row_stride<kDP>();
  constexpr int kTile = kKT * kS;
  constexpr int kNT = kDP / 8;   // 8-column output tiles of a warp
  constexpr int kST = kKT / 8;   // 8-key score tiles of a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBQ * kS;    // stages 0, 1
  __nv_bfloat16* Vs = Ks + 2 * kTile;  // stages 0, 1

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the query tiles with the most keys (the last, under a causal mask)
  // start first, so the short ones fill the tail of the launch
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int D = a.D;
  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* k =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const __nv_bfloat16* v =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + hk * a.v_sh;

  // the key range any row of this tile can see, as in flash_fwd_kernel
  const int q_last = min(q0 + kBQ, a.Sq) - 1;
  int k_end = a.kv_limit;
  if (a.causal) k_end = min(k_end, q_last + a.offset + 1);
  int k_begin = 0;
  if (a.window > 0) k_begin = max(0, q0 + a.offset - a.window + 1);
  k_begin = (k_begin / kKT) * kKT;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kKT - 1) / kKT : 0;

  stage_tile<kDP, kBQ>(Qs, q, a.q_ss, q0, a.Sq, D, tid);
  if (n_tiles > 0) {
    stage_tile<kDP, kKT>(Ks, k, a.k_ss, k_begin, a.Sk, D, tid);
    stage_tile<kDP, kKT>(Vs, v, a.v_ss, k_begin, a.Sk, D, tid);
  }
  cp_async_commit();

  // thread (g, t4) of a warp holds query rows row_lo = g and g + 8 of the
  // warp's 16, and columns 2*t4, 2*t4 + 1 of every 8-column tile
  const int g = lane >> 2, t4 = lane & 3;
  const int row_lo = q0 + warp * 16 + g;
  const float neg_inf = __int_as_float(0xff800000);
  const float scale_log2 = a.scale * 1.4426950408889634f;
  float acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {neg_inf, neg_inf}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_begin + t * kKT;
    if (t + 1 < n_tiles) {  // the next tile loads while this one computes
      const int nxt = (t + 1) & 1;
      stage_tile<kDP, kKT>(Ks + nxt * kTile, k, a.k_ss, k0 + kKT, a.Sk, D,
                           tid);
      stage_tile<kDP, kKT>(Vs + nxt * kTile, v, a.v_ss, k0 + kKT, a.Sk, D,
                           tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + (t & 1) * kTile;
    const __nv_bfloat16* Vt = Vs + (t & 1) * kTile;

    // S = Q . K^T: 16 rows x kKT keys a warp, in 16x8 tiles
    float s[kST][4];
#pragma unroll
    for (int n = 0; n < kST; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDP / 16; ++kk) {
      unsigned qa[4];
      ldsm_x4(qa, Qs + (warp * 16 + (lane & 15)) * kS + kk * 16 +
                      (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < kST / 2; ++nj) {  // key tiles 2*nj, 2*nj + 1
        unsigned kb[4];
        ldsm_x4(kb, Kt + (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * kS +
                        kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * nj], qa, kb[0], kb[1]);
        mma_bf16(s[2 * nj + 1], qa, kb[2], kb[3]);
      }
    }

    // scale into the log2 domain; mask only a tile that crosses an edge
    const bool edge = k0 + kKT > a.kv_limit ||
                      (a.causal && k0 + kKT - 1 > q0 + a.offset) ||
                      (a.window > 0 &&
                       k0 <= q0 + kBQ - 1 + a.offset - a.window);
#pragma unroll
    for (int n = 0; n < kST; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge) {
          const int i = row_lo + (e >> 1) * 8;
          const int j = k0 + n * 8 + 2 * t4 + (e & 1);
          bool ok = j < a.kv_limit;
          if (a.causal) ok = ok && j <= i + a.offset;
          if (a.window > 0) ok = ok && j > i + a.offset - a.window;
          if (!ok) x = neg_inf;
        }
        s[n][e] = x;
      }

    // online softmax; the 4 lanes of a row are a quad
    float mt[2] = {neg_inf, neg_inf};
#pragma unroll
    for (int n = 0; n < kST; ++n) {
      mt[0] = fmaxf(mt[0], fmaxf(s[n][0], s[n][1]));
      mt[1] = fmaxf(mt[1], fmaxf(s[n][2], s[n][3]));
    }
    float base[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m[r], mt[r]);
      base[r] = m_new == neg_inf ? 0.f : m_new;  // a row with nothing yet
      alpha[r] = fast_exp2(m[r] - base[r]);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // P = exp2(S - m) rounded to bf16, as the A fragments of the PV product
    unsigned pa[kKT / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKT / 16; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = 2 * kk + half;
        float p0, p1, p2, p3;
        pa[kk][2 * half] = pack_bf16(fast_exp2(s[n][0] - base[0]),
                                     fast_exp2(s[n][1] - base[0]), p0, p1);
        pa[kk][2 * half + 1] = pack_bf16(fast_exp2(s[n][2] - base[1]),
                                         fast_exp2(s[n][3] - base[1]), p2, p3);
        l[0] += p0 + p1;
        l[1] += p2 + p3;
      }

    // O += P . V: V's B fragments by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kKT / 16; ++kk) {
#pragma unroll
      for (int dn = 0; dn < kDP / 16; ++dn) {  // column tiles 2*dn, 2*dn + 1
        unsigned vb[4];
        ldsm_x4_trans(vb, Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                   kS +
                              dn * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dn], pa[kk], vb[0], vb[1]);
        mma_bf16(acc[2 * dn + 1], pa[kk], vb[2], vb[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }

  // l over the quad, then out = acc / l_safe
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / (l[r] == 0.f ? 1.f : l[r]);
    // m is the max in log2 units of the scaled scores and l sums exp2(s -
    // m), so the natural-log lse is m ln 2 + log l
    const int i = row_lo + r * 8;
    if (a.lse != nullptr && t4 == 0 && i < a.Sq)
      a.lse[(static_cast<long long>(b) * a.Hq + h) * a.Sq + i] =
          m[r] == neg_inf ? kNegInf
                          : m[r] * 0.6931471805599453f + logf(l[r]);
  }
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o) +
                     (static_cast<long long>(b) * a.Hq + h) *
                         static_cast<long long>(a.Sq) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row_lo + r * 8;
    if (i >= a.Sq) continue;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const int col = n * 8 + 2 * t4;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(o + static_cast<long long>(i) * D +
                                           col) =
            __floats2bfloat162_rn(acc[n][2 * r] * inv[r],
                                  acc[n][2 * r + 1] * inv[r]);
    }
  }
}

template <int kDP>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  constexpr int kKT = kDP == 256 ? 32 : kDP == 192 ? 48 : 64;
  constexpr size_t kSmemBytes = mma_smem_bytes<kDP, kKT>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<kDP, kKT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.Hq, a.B);
  flash_fwd_mma_kernel<kDP, kKT><<<grid, kMmaThreads, kSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike); lse: null, or
// (B, Hq, Sq) float32 to receive each row's log-sum-exp.
int flash_attention_fwd(int dtype, const void* q, const void* k,
                        const void* v, void* out, int B, int Hq, int Hkv,
                        int Sq, int Sk, int D, long long q_sb, long long q_sh,
                        long long q_ss, long long k_sb, long long k_sh,
                        long long k_ss, long long v_sb, long long v_sh,
                        long long v_ss, float scale, int causal, int window,
                        int kv_limit, int offset, float* lse, void* stream) {
  if (D < 1 || D > 256 || Hkv < 1 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0 || Hq == 0) return 0;
  const Args a{q,    k,    v,    out,   B,      Hq,     Hkv,      Sq,
               Sk,   D,    q_sb, q_sh,  q_ss,   k_sb,   k_sh,     k_ss,
               v_sb, v_sh, v_ss, scale, causal, window, kv_limit, offset,
               lse};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(dispatch<float>(a, s));
  if (dtype == 1) return static_cast<int>(dispatch<__nv_bfloat16>(a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core kernel: bfloat16 q, k, v and out, D % 8 == 0, every row
// start 16-byte aligned (the wrapper checks pointers and strides).
int flash_attention_fwd_mma(const void* q, const void* k, const void* v,
                            void* out, int B, int Hq, int Hkv, int Sq, int Sk,
                            int D, long long q_sb, long long q_sh,
                            long long q_ss, long long k_sb, long long k_sh,
                            long long k_ss, long long v_sb, long long v_sh,
                            long long v_ss, float scale, int causal,
                            int window, int kv_limit, int offset, float* lse,
                            void* stream) {
  if (D < 8 || D > 256 || D % 8 != 0 || Hkv < 1 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0 || Hq == 0) return 0;
  const Args a{q,    k,    v,    out,   B,      Hq,     Hkv,      Sq,
               Sk,   D,    q_sb, q_sh,  q_ss,   k_sb,   k_sh,     k_ss,
               v_sb, v_sh, v_ss, scale, causal, window, kv_limit, offset,
               lse};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64) return static_cast<int>(launch_mma<64>(a, s));
  if (D <= 128) return static_cast<int>(launch_mma<128>(a, s));
  if (D <= 192) return static_cast<int>(launch_mma<192>(a, s));
  return static_cast<int>(launch_mma<256>(a, s));
}

}  // extern "C"
