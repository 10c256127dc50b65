// Flash-decode: one new query token per sequence against its KV cache,
// hand-written for Hopper (sm_90a), with the cache split across blocks.
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
// Bound: device-memory bytes (the cache is read once; ~2 FLOP per byte), so
// every cache byte is read once and the read is spread over the card.  Where
// the TPU kernel walks the key blocks of one (b, kv head) as a sequential
// grid dimension, here the grid is (split, kv head, b): split s owns cache
// slots [s*chunk, (s+1)*chunk), chunk a multiple of 64 that the wrapper picks
// from the slot count S alone (never from lengths, which stay on the card),
// so that B*Hkv*splits fills the SMs.  As in the Pallas grid, a block scores
// the query heads of its kv head against each cache row, at most kGMax = 16
// of them: a larger group (MLA's absorbed decode: 128 query heads on one
// latent kv head) is tiled over the grid's y axis, so the grid is (split,
// kv head x group tile, b) and each group tile re-reads the same cache chunk
// (from L2 after the first).  It walks its
// chunk up to lengths[b] in 64-key tiles staged in shared memory by 16-byte
// cp.async copies (K of the next tile loads during this tile's PV; rows the
// copies cannot take are staged element by element): 4 threads per key
// score up to 4 heads each, one warp per head updates (m, l), and each
// thread accumulates its share of the 16 x D outputs from the tile's V rows:
// column d of every head for each full pass of 256 columns, and of the
// columns left over (D % 256) one column of every (256 / left)-th head.
//
// With one split the block writes the output.  Otherwise it writes its
// partial (m, l, acc) per head to a float32 workspace (B, Hq, splits, D + 2),
// and one thread fences and takes a ticket on the arrival counter of its
// (b, kv head, group tile).  The last block to arrive combines the splits
// (the global max, alpha-rescaled sums, l == 0 -> l_safe = 1), writes the
// output and resets the counter to 0, so one launch does the whole call
// and the counters are all zero between calls.  A block whose chunk starts
// at or past lengths[b] writes m = -1e30, l = 0 and zeros, and reads
// nothing of the cache; its weight in the combine is 0.
//
// Templated on the head-dimension cap DMax: 128, 256 (recurrentgemma's local
// attention: head_dim 256, G = 10 query heads on one kv head) and, in bf16
// only, 576 (MLA's latent cache, 512 + 64 wide, G = 128): two bf16 tiles of
// 64 x 584 and the float32 query rows take 190 KB of shared memory, and the
// float32 tiles would not fit, so float32 stops at D = 256.  The group size
// is free: the workspace is indexed by query head.  Strided caches (element
// strides, D contiguous)
// are read in place; q and out are contiguous (B, Hq, D).  The C entry point
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;        // keys per tile
constexpr int kGMax = 16;      // query heads a block: the group tile
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kKeyThreads = kThreads / kBK;  // threads (head groups) a key
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// 16 bytes of T as floats
__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* f) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the top half of its float
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 16 bytes global -> shared; with valid == false the 16 bytes are zeros and
// nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* lengths;
  void* o;
  float* ws;       // B*Hq*splits*(D + 2) floats of partials: acc rows
                   // [B][Hq][splits][D], then (m, l) [B][Hq][splits][2];
                   // unused with one split
  int* arrivals;   // (B * Hkv * group tiles,) arrival counters, 0 between
                   // calls
  int Hq, Hkv, S, D, chunk, splits, vec;
  long long k_sb, k_sh, k_ss;  // element strides; the D axis is contiguous
  long long v_sb, v_sh, v_ss;
  float scale;
};

template <typename T, int kDMax>
struct Tile {
  static constexpr int kVec = 16 / sizeof(T);   // elements per 16 bytes
  static constexpr int kStride = kDMax + kVec;  // shared row, 16 B of padding
  static constexpr size_t kBytes = sizeof(T) * kBK * kStride;
};

// cache rows [k0, k0 + n) into a kBK-row shared tile, rows [n, kBK) zeros
// (the PV loop then runs to a multiple of 4 keys): 16-byte cp.async copies
// when vec (D a multiple of kVec, rows 16-byte aligned), else element by
// element with columns [D, round_up(D, kVec)) zeroed too, so the score
// loop's 16-byte reads see zeros past D
template <typename T, int kDMax>
__device__ __forceinline__ void stage(T* dst, const T* src, long long ss,
                                      int k0, int n, int D, int vec,
                                      int tid) {
  using L = Tile<T, kDMax>;
  if (vec) {
    constexpr int kChunks = kDMax / L::kVec;
#pragma unroll
    for (int it = 0; it < kBK * kChunks / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / kChunks, c = i % kChunks;
      if (c * L::kVec < D)
        cp_async16(dst + r * L::kStride + c * L::kVec,
                   r < n ? src + (k0 + r) * ss + c * L::kVec : src, r < n);
    }
  } else {
    const int nd = (D + L::kVec - 1) / L::kVec * L::kVec;
    for (int r = tid / 32; r < kBK; r += kWarps)
      for (int d = tid % 32; d < nd; d += 32)
        dst[r * L::kStride + d] =
            r < n && d < D ? src[(k0 + r) * ss + d] : zero<T>();
  }
}

// V columns of the workspace's acc rows as floats (16-byte loads for V = 4;
// .cg: the rows were written by other blocks)
template <int V>
__device__ __forceinline__ void load_cols(const float* p, float* f);
template <>
__device__ __forceinline__ void load_cols<4>(const float* p, float* f) {
  const float4 x = __ldcg(reinterpret_cast<const float4*>(p));
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}
template <>
__device__ __forceinline__ void load_cols<1>(const float* p, float* f) {
  f[0] = __ldcg(p);
}

// out[g, c*V .. c*V + V) = inv_l[g] * sum over splits s of w[g, s] *
// part[g, s, c*V ..] for every head g < G and column group c of the block's
// group tile; each thread takes (g, c) items and keeps 16 splits' loads in
// flight, since the workspace rows come from L2 and latency, not bytes,
// bounds one block's walk over them
template <int V, typename T>
__device__ __forceinline__ void combine(const float* part, const float* w_s,
                                        const float* inv_l, T* out, int G,
                                        int D, int splits, int tid) {
  constexpr int kBatch = 16;
  const int nc = D / V;
  for (int item = tid; item < G * nc; item += kThreads) {
    const int g = item / nc, c = item - g * nc;
    const float* src = part + static_cast<long long>(g) * splits * D + c * V;
    const float* w = w_s + g * splits;
    float x[V];
#pragma unroll
    for (int e = 0; e < V; ++e) x[e] = 0.f;
    for (int s0 = 0; s0 < splits; s0 += kBatch) {
      float v[kBatch][V];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (s0 + u < splits) {
          load_cols<V>(src + static_cast<long long>(s0 + u) * D, v[u]);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) v[u][e] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const float wu = s0 + u < splits ? w[s0 + u] : 0.f;
#pragma unroll
        for (int e = 0; e < V; ++e) x[e] = fmaf(wu, v[u][e], x[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < V; ++e) store(out + g * D + c * V + e, x[e] * inv_l[g]);
  }
}

template <typename T, int kDMax>
// one block an SM as the floor: ptxas then keeps the float32 D = 256
// instance (kAcc = 16 accumulators beside the combine's loads) out of spills
__global__ void __launch_bounds__(kThreads, 1) decode_kernel(Args a) {
  using L = Tile<T, kDMax>;
  // thread tid owns column tid + j*kThreads of every head for j < kFull,
  // and column kFull*kThreads + tid % kRem of heads tid / kRem + i*kRemStep
  // (kRem = kDMax % kThreads columns left over): DMax 128 -> 1 column of 8
  // heads, 256 -> 1 of 16, 576 -> 2 of 16 and 1 of 4, 36 outputs a thread
  constexpr int kFull = kDMax / kThreads;
  constexpr int kRem = kDMax % kThreads;
  constexpr int kRemDiv = kRem ? kRem : 1;  // a divisor where kRem is 0
  constexpr int kRemStep = kThreads / kRemDiv;
  constexpr int kRemHeads = kRem ? kGMax / kRemStep : 0;
  constexpr int kCols = kFull + (kRem ? 1 : 0);  // columns a thread owns
  constexpr int kAcc = kFull * kGMax + kRemHeads;  // outputs a thread
  static_assert(kThreads % kRemDiv == 0 &&
                    (kRem == 0 || kGMax % kRemStep == 0),
                "the columns left over must split the threads evenly");
  static_assert(kAcc * kThreads == kGMax * kDMax, "every output owned once");
  __shared__ __align__(16) float qs[kGMax * kDMax];
  __shared__ __align__(16) float ps[kGMax][kBK];
  __shared__ float m_s[kGMax], l_s[kGMax], alpha_s[kGMax];
  __shared__ int last_s;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + kBK * L::kStride;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x;
  const int b = blockIdx.z;
  const int group = a.Hq / a.Hkv;
  const int tiles = (group + kGMax - 1) / kGMax;  // group tiles a kv head
  const int hk = blockIdx.y / tiles;
  const int gt = blockIdx.y - hk * tiles;
  const int G = min(kGMax, group - gt * kGMax);   // this block's heads
  const int h0 = hk * group + gt * kGMax;         // its first query head
  const int D = a.D;
  const int len = max(0, min(a.lengths[b], a.S));
  const int c0 = split * a.chunk;
  const int c1 = min(c0 + a.chunk, len);  // this block's keys: [c0, c1)
  const T* q = static_cast<const T*>(a.q) +
               (static_cast<long long>(b) * a.Hq + h0) * D;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  if (tid < kGMax) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  if (c0 < c1) {
    stage<T, kDMax>(Ks, k, a.k_ss, c0, min(kBK, c1 - c0), D, a.vec, tid);
    cp_async_commit();
    stage<T, kDMax>(Vs, v, a.v_ss, c0, min(kBK, c1 - c0), D, a.vec, tid);
    cp_async_commit();
#pragma unroll
    for (int it = 0; it < kGMax * kDMax / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int g = i / kDMax, d = i % kDMax;
      qs[i] = (g < G && d < D) ? to_f(q[g * D + d]) : 0.f;
    }
  }
  const int kk = tid % kBK;          // the key this thread scores
  const int hg = tid / kBK;          // its heads: hg, hg + 4, ...
  // its outputs: acc[c * kGMax + u] is column col(c) of head u for a full
  // pass c < kFull; acc[kFull * kGMax + u] column col(kFull) of head
  // g_rem + u * kRemStep
  const int g_rem = tid / kRemDiv;
  auto col = [tid](int c) {
    return c < kFull ? tid + c * kThreads : kFull * kThreads + tid % kRemDiv;
  };
  auto head = [g_rem](int i) {
    return i < kFull * kGMax ? i % kGMax
                             : g_rem + (i - kFull * kGMax) * kRemStep;
  };
  const int nv = (D + L::kVec - 1) / L::kVec;

  for (int k0 = c0; k0 < c1; k0 += kBK) {
    const int n = min(kBK, c1 - k0);
    cp_async_wait1();  // K of this tile is in
    __syncthreads();

    // scores: each of a key's 4 threads takes every 4th head
    float dot[kGMax / kKeyThreads];
#pragma unroll
    for (int u = 0; u < kGMax / kKeyThreads; ++u) dot[u] = 0.f;
    const T* krow = Ks + kk * L::kStride;
    for (int c = 0; c < nv; ++c) {
      float kf[L::kVec];
      load16(krow + c * L::kVec, kf);
#pragma unroll
      for (int u = 0; u < kGMax / kKeyThreads; ++u) {
        const int g = hg + u * kKeyThreads;
        if (g < G) {
          const float* qg = qs + g * kDMax + c * L::kVec;
#pragma unroll
          for (int e = 0; e < L::kVec; e += 4) {
            const float4 q4 = *reinterpret_cast<const float4*>(qg + e);
            dot[u] = fmaf(q4.x, kf[e], dot[u]);
            dot[u] = fmaf(q4.y, kf[e + 1], dot[u]);
            dot[u] = fmaf(q4.z, kf[e + 2], dot[u]);
            dot[u] = fmaf(q4.w, kf[e + 3], dot[u]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kGMax / kKeyThreads; ++u) {
      const int g = hg + u * kKeyThreads;
      if (g < G) ps[g][kk] = kk < n ? dot[u] * a.scale : kNegInf;
    }
    __syncthreads();  // K is read; ps is complete

    if (k0 + kBK < c1)  // the next tile's K loads during the softmax and PV
      stage<T, kDMax>(Ks, k, a.k_ss, k0 + kBK, min(kBK, c1 - k0 - kBK), D,
                      a.vec, tid);
    cp_async_commit();

    // online-softmax statistics, one warp per head
    for (int g = warp; g < G; g += kWarps) {
      const float s0 = ps[g][lane], s1 = ps[g][lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = lane < n ? expf(s0 - m_new) : 0.f;
      const float p1 = lane + 32 < n ? expf(s1 - m_new) : 0.f;
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
    cp_async_wait1();  // V of this tile is in
    __syncthreads();

    // PV: each V element is read once for all of the thread's heads of
    // its column, and each head's probabilities four keys at a time
    // (shared-memory load issue, not arithmetic, bounds this loop)
#pragma unroll
    for (int i = 0; i < kAcc; ++i)
      if (head(i) < G) acc[i] *= alpha_s[head(i)];
    for (int j = 0; j < n; j += 4) {  // rows and p past n are zeros
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = col(c);
        if (d < D) {
          const T* vcol = Vs + d;
          const float v0 = to_f(vcol[j * L::kStride]);
          const float v1 = to_f(vcol[(j + 1) * L::kStride]);
          const float v2 = to_f(vcol[(j + 2) * L::kStride]);
          const float v3 = to_f(vcol[(j + 3) * L::kStride]);
#pragma unroll
          for (int u = 0; u < (c < kFull ? kGMax : kRemHeads); ++u) {
            const int i = c * kGMax + u;
            if (head(i) < G) {
              const float4 p =
                  *reinterpret_cast<const float4*>(&ps[head(i)][j]);
              acc[i] = fmaf(p.x, v0, acc[i]);
              acc[i] = fmaf(p.y, v1, acc[i]);
              acc[i] = fmaf(p.z, v2, acc[i]);
              acc[i] = fmaf(p.w, v3, acc[i]);
            }
          }
        }
      }
    }
    __syncthreads();  // V and ps are rewritten by the next tile

    if (k0 + kBK < c1)
      stage<T, kDMax>(Vs, v, a.v_ss, k0 + kBK, min(kBK, c1 - k0 - kBK), D,
                      a.vec, tid);
    cp_async_commit();
  }
  __syncthreads();  // m_s, l_s as the last tile left them

  T* out = static_cast<T*>(a.o) + (static_cast<long long>(b) * a.Hq + h0) * D;
  if (a.splits == 1) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int g = head(i), d = col(i / kGMax);
      if (g < G && d < D) {
        const float l = l_s[g];
        store(out + g * D + d, acc[i] / (l == 0.f ? 1.f : l));
      }
    }
    return;
  }

  // this split's partial: head h = h0 + g's acc row at
  // ((b*Hq + h) * splits + split) * D, its (m, l) at the same index * 2
  // past the acc rows
  const long long first = (static_cast<long long>(b) * a.Hq + h0) *
                          a.splits;  // (b, h0, split 0)
  float* part = a.ws + first * D;
  float* stats = a.ws + static_cast<long long>(gridDim.z) * a.Hq * a.splits *
                            D + first * 2;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {  // zeros from an empty chunk
    const int g = head(i), d = col(i / kGMax);
    if (g < G && d < D)
      part[(static_cast<long long>(g) * a.splits + split) * D + d] = acc[i];
  }
  if (tid < G) {
    stats[(tid * a.splits + split) * 2] = m_s[tid];
    stats[(tid * a.splits + split) * 2 + 1] = l_s[tid];
  }
  // the barrier orders the block's writes before thread 0's fence, which
  // orders them before its ticket: one fence and one atomic a block
  __syncthreads();
  int* arrivals = a.arrivals + static_cast<long long>(b) * gridDim.y +
                  blockIdx.y;
  if (tid == 0) {
    __threadfence();
    last_s = atomicAdd(arrivals, 1) == a.splits - 1;
    if (last_s) __threadfence();
  }
  __syncthreads();
  if (!last_s) return;

  // the last block combines: per head the global max M over splits with
  // l > 0, each split's weight w = exp(m - M) (0 where l == 0; kept in the
  // tile memory, free now) and 1 / L, L = sum of w * l (1 where 0); then
  // out = sum of w * acc / L
  float* w_s = reinterpret_cast<float*>(smem_raw);  // [kGMax][splits]
  for (int g = warp; g < G; g += kWarps) {
    const float* st = stats + g * a.splits * 2;  // (m, l) of each split
    float mx = kNegInf;
    for (int s = lane; s < a.splits; s += 32)
      if (__ldcg(st + 2 * s + 1) > 0.f) mx = fmaxf(mx, __ldcg(st + 2 * s));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int s = lane; s < a.splits; s += 32) {
      const float l = __ldcg(st + 2 * s + 1);
      const float w = l > 0.f ? expf(__ldcg(st + 2 * s) - mx) : 0.f;
      w_s[g * a.splits + s] = w;
      sum += w * l;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) l_s[g] = 1.f / (sum == 0.f ? 1.f : sum);
  }
  __syncthreads();
  if (D % 4 == 0)
    combine<4>(part, w_s, l_s, out, G, D, a.splits, tid);
  else
    combine<1>(part, w_s, l_s, out, G, D, a.splits, tid);
  if (tid == 0) *arrivals = 0;
}

template <typename T, int kDMax>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  constexpr size_t kSmemBytes = 2 * Tile<T, kDMax>::kBytes;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T, kDMax>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int tiles = (a.Hq / a.Hkv + kGMax - 1) / kGMax;
  const dim3 grid(a.splits, a.Hkv * tiles, B);
  decode_kernel<T, kDMax><<<grid, kThreads, kSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32 (D <= 256), 1 = bfloat16 (D <= 576) (q, caches and out
// alike).  ws and arrivals (B * Hkv * ceil(G / 16) counters) are used only
// when splits > 1; vec: the caches' rows take 16-byte copies.
int decode_attention_fwd(int dtype, const void* q, const void* k,
                         const void* v, const int32_t* lengths, void* out,
                         float* ws, int* arrivals, int B, int Hq, int Hkv,
                         int S, int D, int chunk, int splits, int vec,
                         long long k_sb, long long k_sh, long long k_ss,
                         long long v_sb, long long v_sh, long long v_ss,
                         float scale, void* stream) {
  // the combine's weights, kGMax x splits floats, reuse the tile memory of
  // the smallest instance
  if (D < 1 || D > (dtype == 0 ? 256 : 576) || Hkv < 1 || Hq % Hkv != 0 ||
      static_cast<long long>(Hkv) * ((Hq / Hkv + kGMax - 1) / kGMax) >
          65535 ||
      splits < 1 || chunk < kBK || chunk % kBK != 0 ||
      kGMax * splits * sizeof(float) > 2 * Tile<__nv_bfloat16, 128>::kBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Hq == 0) return 0;
  const Args a{q,    k,      v,    lengths, out,  ws,   arrivals,
               Hq,   Hkv,    S,    D,       chunk, splits, vec,
               k_sb, k_sh,   k_ss, v_sb,    v_sh, v_ss, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(D <= 128 ? launch<float, 128>(a, B, s)
                                     : launch<float, 256>(a, B, s));
  if (dtype == 1)
    return static_cast<int>(D <= 128   ? launch<__nv_bfloat16, 128>(a, B, s)
                            : D <= 256 ? launch<__nv_bfloat16, 256>(a, B, s)
                                       : launch<__nv_bfloat16, 576>(a, B, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
