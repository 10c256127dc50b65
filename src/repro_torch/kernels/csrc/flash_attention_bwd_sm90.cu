// Flash attention's backward at head dimensions 192 and 256 on Hopper's
// tensor cores (sm_90a): wgmma fed by TMA.
//
// Replaces, with csrc/flash_attention_bwd.cu, the custom VJP of
// src/repro/models/flash_xla.py (_flash_bwd, registered with defvjp), the
// FlashAttention-2 backward the JAX trainer runs through
// flash_attention_xla; this source is its route "wgmma": bfloat16 q, k, v,
// out and dout at 128 < D <= 256, D % 8 == 0, every row on 16 bytes.  For
// q (B, Hq, Sq, D), k, v (B, Hkv, Sk, D), Hq = G * Hkv, the forward's out
// and row log-sum-exp lse (B, Hq, Sq) float32, and the output gradient dO:
//
//   S = scale * q k^T,  P = exp(S - lse) on the visible keys (0 elsewhere),
//   Dsum = rowsum(dO o out),  dP = dO v^T,  dS = P o (dP - Dsum),
//   dq = scale * dS k,  dk = scale * dS^T q,  dv = P^T dO,
//
// with dk and dv summed over the G query heads of each kv head.  Visibility
// is the forward's: j < Sk, and with `causal` j <= i + offset, and with a
// window w > 0 also j > i + offset - w.  P and dS (dS made from the
// unrounded P) are rounded to bf16 before their products, as the
// mma.sync route does; sums are float32 and dq, dk, dv are rounded once.
//
// Bound: operations, 10 * D FLOP a visible (query, key) pair a head (five
// products); at recurrentgemma-2b's training shape (B 2, 10 query heads on
// 1 kv head, S 4,096, a 2,048-token window, D 256) 322.2 GFLOP, 0.33 ms at
// the bf16 peak of 989 TFLOP/s.  The two walks recompute S and dP, seven
// products in all.  Why the mma.sync route stops at D 128: at 16 keys a
// warp, dK's and dV's float32 accumulators alone are D registers a lane.
// A wgmma warpgroup holds an m64 x D accumulator in D / 2 registers a
// thread.
//
// Launches, in order on the caller's stream, with no atomics, so two calls
// give bitwise-equal gradients:
//   ld_wgmma_kernel    one warp a query row: lse * log2(e) and Dsum into a
//                      float32 scratch padded to 64-row tiles, each tile's
//                      64 of each adjacent (512 bytes a tile, one bulk
//                      copy); rows past Sq get +inf (P = 0 there) and 0;
//   dkdv_wgmma_kernel  one CTA per (64-key tile, kv head, b): K and V of
//                      the tile stay in shared memory while the CTA walks
//                      the query tiles of the kv head's G query heads
//                      that see the key tile; one producer thread
//                      loads each step's Q and dO (64 rows, boxes of 64
//                      columns, 128-byte swizzle, from (B, H, S, D) strided
//                      tensor maps) and its lse/Dsum tile into a 2-stage
//                      ring (3 at D 192), and two consumer warpgroups of
//                      wgmma take a step each: warpgroup 0 makes S^T =
//                      K.Q^T (m64n64, both K-major), P^T in registers,
//                      hands P^T (float32) to warpgroup 1 through shared
//                      memory and adds dV += P^T.dO (A = P^T from
//                      registers, dO MN-major); warpgroup 1 makes dP^T =
//                      V.dO^T, dS^T = P^T o (dP^T - Dsum) and adds dK +=
//                      dS^T.Q.  Each warpgroup holds one m64 x D float32
//                      accumulator (128 registers a thread at D 256;
//                      setmaxnreg gives the consumers 240).  Key tiles
//                      launch heaviest first (the key tile slowest over
//                      the flat grid); dk and dv are stored in bf16;
//   dq_wgmma_kernel    one CTA per (64-query tile, q head, b): Q and dO
//                      stay in shared memory, the key tiles the query tile
//                      sees stream through a 2-stage ring (3 at D 192);
//                      one warpgroup makes S = Q.K^T and dP = dO.V^T, dS in
//                      registers, and adds dQ += dS.K (K MN-major); query
//                      tiles with the most keys launch first.
// Every wgmma's operand registers are pinned around it (fence_operand) and
// each dK/dV warpgroup runs its own loop: a register access the compiler
// may move across a wgmma, or a wgmma behind a branch on the warpgroup,
// makes ptxas serialize the wgmmas (its warning C7520), which cost this
// kernel a fifth of its time.
// Tiles wholly outside the causal or window mask are skipped; the mask is
// applied in registers only on tiles that cross the diagonal, the
// window's edge or the ragged end.  At recurrentgemma-2b's shape the dK/dV
// grid is 128 CTAs for 132 SMs, the first 32 key tiles twice as heavy
// under the window.  Splitting each key tile's query heads over CTAs, with
// a second pass summing float32 partials, fills the card better (a call
// about 11% faster there) but does not move the training step beyond its
// noise, so each CTA walks all of its kv head's query heads.
//
// Instances at D 192 (MLA's q.k width, v zero-padded from 128) and 256
// (recurrentgemma-2b, gemma-2b); a D in between is zero-filled by TMA
// into the next instance (columns past D read as zeros, never stored).
// Rows past Sq or Sk read as zeros too.  Shared memory at D 256: K and V
// 64 KB, the ring 2 x 64 KB, the lse/Dsum tiles 1 KB, the P^T hand-off
// 16 KB (dK/dV, 211 KB); Q and dO 64 KB and the ring 2 x 64 KB (dQ, 193
// KB): one CTA an SM.
//
// The C entry encodes the tensor maps, launches on the caller's stream,
// allocates nothing and returns cudaGetLastError() (or the refusal).

#include <cuda_bf16.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kT = 64;            // keys a dK/dV CTA, queries a step or dQ CTA
constexpr int kBox = kT * 128;    // one box: 64 rows of 64 bf16 (8 KB)
constexpr int kLd = 2 * kT;       // floats of a query tile's lse/Dsum
constexpr int kConsumers = 256;   // dK/dV: two consumer warpgroups
constexpr int kDkdvThreads = kConsumers + 128;   // and the producer's
constexpr int kDqThreads = 128 + 32;             // one warpgroup, a producer
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const bf16* out;
  const bf16* dout;
  const float* lse;  // (B, Hq, Sq)
  float* ld;         // (B, Hq, n_qt, 2, 64): lse * log2(e), Dsum
  bf16* dq;          // (B, Hq, Sq, D) contiguous
  bf16* dk;          // (B, Hkv, Sk, D) contiguous
  bf16* dv;
  int B, Hq, Hkv, Sq, Sk, D;
  long long o_sb, o_sh, o_ss;
  long long do_sb, do_sh, do_ss;
  float scale;
  int causal, window, offset;
  int n_qt;          // 64-row query tiles
};

// shared memory of the dK/dV kernel with 64-row tiles of `tile` bytes and
// n ring stages: K, V, n stages of (Q, dO) and their lse/Dsum tiles, P^T,
// barriers (and 1 KB to align the tiles on 1,024 bytes)
constexpr int dkdv_smem(int tile, int n) {
  return 1024 + 2 * tile + n * (2 * tile + kLd * 4) + 32 * 128 * 4 +
         8 * (2 * n + 1);
}

// tiles of one instance: kBoxes boxes of 64 columns a 64-row tile; 3
// stages where they fit (D 192), else 2
template <int kD>
struct Cfg {
  static constexpr int kBoxes = kD / 64;
  static constexpr int kTile = kBoxes * kBox;
  static constexpr int kStages = dkdv_smem(kTile, 3) <= 232448 ? 3 : 2;
  static constexpr int kDkdvSmem = dkdv_smem(kTile, kStages);
  // dQ: Q, dO, the ring of (K, V), barriers
  static constexpr int kDqSmem =
      1024 + 2 * kTile + kStages * 2 * kTile + 8 * (2 * kStages + 1);
  static_assert(kD % 64 == 0, "whole boxes");
  static_assert(kDkdvSmem <= 232448 && kDqSmem <= 232448,
                "shared memory per block");
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ bool visible(const Args& a, int i, int j) {
  bool ok = i < a.Sq && j < a.Sk;
  if (a.causal) ok = ok && j <= i + a.offset;
  if (a.window > 0) ok = ok && j > i + a.offset - a.window;
  return ok;
}

// whether the tile of queries [q0, q0 + 64) and keys [k0, k0 + 64) holds
// a pair that is not visible
__device__ __forceinline__ bool crosses_edge(const Args& a, int q0, int k0) {
  return q0 + kT > a.Sq || k0 + kT > a.Sk ||
         (a.causal && k0 + kT - 1 > q0 + a.offset) ||
         (a.window > 0 && k0 <= q0 + kT - 1 + a.offset - a.window);
}

// a k16 step's A fragment from the m64n64 accumulator's columns 16 kk ..
// 16 kk + 15 (the accumulator's C layout is the A layout of m64k16)
__device__ __forceinline__ void a_frag(uint32_t (&f)[4], const float* c,
                                       int kk) {
  f[0] = pack_bf16(c[8 * kk + 0], c[8 * kk + 1]);
  f[1] = pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
  f[2] = pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
  f[3] = pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
}

// d (m64 x kD) += A . B over the 64 rows of a tile, A from registers (four
// k16 fragments), B a 64-row tile in shared memory, MN-major
template <int kD>
__device__ __forceinline__ void mma_rs(float (&d)[kD / 2],
                                       uint32_t (&f)[4][4],
                                       const unsigned char* b) {
  fence_operand(d);
  fence_operand(f);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = desc_sw128(b + kk * 2048, kBox, 1024);
    if constexpr (kD == 256)
      wgmma_m64n256_rs(d, f[kk], db);
    else
      wgmma_m64n192_rs(d, f[kk], db);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_operand(d);
}

// c (m64n64) += A . B^T over the kD columns of two 64-row tiles in shared
// memory, both K-major
template <int kD>
__device__ __forceinline__ void issue_nt(float (&c)[32],
                                         const unsigned char* a,
                                         const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int off = (kk / 4) * kBox + (kk % 4) * 32;
    wgmma_m64n64_kk(c, desc_sw128(a + off, 16, 1024),
                    desc_sw128(b + off, 16, 1024));
  }
}

// ---------------------------------------------------------------------------
// lse and Dsum, tile by tile
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256) ld_wgmma_kernel(Args a) {
  const long long row =
      static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const long long rows = static_cast<long long>(a.B) * a.Hq * a.n_qt * kT;
  if (row >= rows) return;
  const int i = static_cast<int>(row % (static_cast<long long>(a.n_qt) * kT));
  const long long bh = row / (static_cast<long long>(a.n_qt) * kT);
  const int h = static_cast<int>(bh % a.Hq);
  const int b = static_cast<int>(bh / a.Hq);
  float s = 0.f;
  if (i < a.Sq && lane * 8 < a.D) {   // 16 bytes a lane, D <= 256
    const uint4 o = *reinterpret_cast<const uint4*>(
        a.out + b * a.o_sb + h * a.o_sh + i * a.o_ss + lane * 8);
    const uint4 d = *reinterpret_cast<const uint4*>(
        a.dout + b * a.do_sb + h * a.do_sh + i * a.do_ss + lane * 8);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 of = __bfloat1622float2(o2[e]);
      const float2 df = __bfloat1622float2(d2[e]);
      s = fmaf(of.x, df.x, s);
      s = fmaf(of.y, df.y, s);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    float* t = a.ld + (bh * a.n_qt + i / kT) * kLd;
    t[i % kT] = i < a.Sq ? a.lse[bh * a.Sq + i] * kLog2e
                         : __int_as_float(0x7f800000);
    t[kT + i % kT] = s;
  }
}

// ---------------------------------------------------------------------------
// dK and dV: one CTA per (key tile, kv head, b)
// ---------------------------------------------------------------------------

template <int kD>
__global__ void __launch_bounds__(kDkdvThreads, 1)
    dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                const __grid_constant__ CUtensorMap do_map, Args a) {
  using C = Cfg<kD>;
  constexpr int kStages = C::kStages;
  constexpr int kTile = C::kTile;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ks = align1024(smem_raw);
  unsigned char* Vs = Ks + kTile;
  unsigned char* ring = Vs + kTile;                  // stage s: Q, dO
  float* lds = reinterpret_cast<float*>(ring + kStages * 2 * kTile);
  float* pex = lds + kStages * kLd;                  // P^T, [32][128]
  uint64_t* full = reinterpret_cast<uint64_t*>(pex + 32 * 128);
  uint64_t* empty = full + kStages;
  uint64_t* kv_bar = empty + kStages;

  // the key tile varies slowest over the flat grid, so the heaviest tiles
  // (tile 0 under a causal mask) of every head start first
  const int G = a.Hq / a.Hkv;
  const int per_tile = a.Hkv * a.B;
  const int k0 = static_cast<int>(blockIdx.x / per_tile) * kT;
  const int hk = static_cast<int>(blockIdx.x % per_tile) % a.Hkv;
  const int b = static_cast<int>(blockIdx.x % per_tile) / a.Hkv;

  // the query rows that see a key of this tile, in whole 64-row tiles
  const int k_last = min(k0 + kT, a.Sk) - 1;
  int q_begin = 0, q_end = a.Sq;
  if (a.causal) q_begin = max(0, k0 - a.offset);
  if (a.window > 0) q_end = min(q_end, k_last - a.offset + a.window);
  q_begin = (q_begin / kT) * kT;
  const int qts = q_end > q_begin ? (q_end - q_begin + kT - 1) / kT : 0;
  const int n_steps = G * qts;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);     // one arrival a consumer warpgroup
    }
    mbar_init(kv_bar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---------------- producer: one thread issues every load -------------
    setmaxnreg_dec<24>();
    if (threadIdx.x != kConsumers || n_steps == 0) return;
    mbar_arrive_tx(kv_bar, 2 * kTile);
    for (int x = 0; x < C::kBoxes; ++x) {
      tma_load_4d(Ks + x * kBox, &k_map, kv_bar, 64 * x, k0, hk, b);
      tma_load_4d(Vs + x * kBox, &v_map, kv_bar, 64 * x, k0, hk, b);
    }
    for (int t = 0; t < n_steps; ++t) {
      const int s = t % kStages;
      const int h = hk * G + t / qts;
      const int q0 = q_begin + (t % qts) * kT;
      mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
      unsigned char* Qs = ring + s * 2 * kTile;
      mbar_arrive_tx(&full[s], 2 * kTile + kLd * 4);
      for (int x = 0; x < C::kBoxes; ++x) {
        tma_load_4d(Qs + x * kBox, &q_map, &full[s], 64 * x, q0, h, b);
        tma_load_4d(Qs + kTile + x * kBox, &do_map, &full[s], 64 * x, q0, h,
                    b);
      }
      bulk_load(lds + s * kLd,
                a.ld + ((static_cast<long long>(b) * a.Hq + h) * a.n_qt +
                        q0 / kT) * kLd,
                kLd * 4, &full[s]);
    }
    return;
  }

  // ------------------ consumers: dV (warpgroup 0), dK (1) -----------------
  setmaxnreg_inc<240>();
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const float scale_log2 = a.scale * kLog2e;
  // this thread's accumulator rows (keys) r0 and r0 + 8 of the tile, and
  // columns 8 j + c0, + 1 of every 8-column block
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
  float acc[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) acc[i] = 0.f;
  if (n_steps > 0) mbar_wait(kv_bar, 0);

  // each warpgroup walks the steps with its own code, so no wgmma sits
  // behind a branch on the warpgroup (ptxas would serialize them)
  auto walk = [&](auto dv) {
    for (int t = 0; t < n_steps; ++t) {
      const int s = t % kStages;
      const int q0 = q_begin + (t % qts) * kT;
      const unsigned char* Qs = ring + s * 2 * kTile;
      const unsigned char* dOs = Qs + kTile;
      const float* ld = lds + s * kLd;
      const bool edge = crosses_edge(a, q0, k0);
      mbar_wait(&full[s], (t / kStages) & 1);
      float c[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) c[i] = 0.f;
      uint32_t f[4][4];
      fence_operand(c);
      wgmma_fence();
      if constexpr (decltype(dv)::value) {
        // S^T = K . Q^T, then P^T = exp2(S^T scale log2(e) - lse log2(e)),
        // masked on a tile across an edge
        issue_nt<kD>(c, Ks, Qs);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operand(c);
        if (t > 0) named_barrier(2, 256);   // warpgroup 1 read the last P^T
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = 8 * j + c0 + (e & 1);
            float x = fast_exp2(fmaf(c[4 * j + e], scale_log2, -ld[qi]));
            if (edge && !visible(a, q0 + qi, k0 + r0 + 8 * (e >> 1)))
              x = 0.f;
            c[4 * j + e] = x;
            pex[(4 * j + e) * 128 + tid] = x;
          }
        named_barrier_arrive(1, 256);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) a_frag(f[kk], c, kk);
        mma_rs<kD>(acc, f, dOs);             // dV += P^T . dO
      } else {
        // dP^T = V . dO^T, then dS^T = P^T o (dP^T - Dsum)
        issue_nt<kD>(c, Vs, dOs);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operand(c);
        named_barrier(1, 256);               // P^T is in pex
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = 8 * j + c0 + (e & 1);
            c[4 * j + e] =
                pex[(4 * j + e) * 128 + tid] * (c[4 * j + e] - ld[kT + qi]);
          }
        if (t + 1 < n_steps) named_barrier_arrive(2, 256);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) a_frag(f[kk], c, kk);
        mma_rs<kD>(acc, f, Qs);              // dK += dS^T . Q
      }
      if (tid == 0) mbar_arrive(&empty[s]);
    }
  };
  if (wg == 0)
    walk(std::true_type{});   // dV
  else
    walk(std::false_type{});  // dK

  // dV (warpgroup 0) and dK (1, times scale) in bf16
  const long long row0 =
      (static_cast<long long>(b) * a.Hkv + hk) * a.Sk + k0;
  const float mul = wg == 1 ? a.scale : 1.f;
  bf16* dst = wg == 0 ? a.dv : a.dk;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = r0 + 8 * hh;
    if (k0 + key >= a.Sk) continue;
    const long long at = (row0 + key) * a.D;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const int col = 8 * j + c0;
      if (col >= a.D) continue;
      *reinterpret_cast<__nv_bfloat162*>(dst + at + col) =
          __floats2bfloat162_rn(acc[4 * j + 2 * hh] * mul,
                                acc[4 * j + 2 * hh + 1] * mul);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: one CTA per (query tile, q head, b)
// ---------------------------------------------------------------------------

template <int kD>
__global__ void __launch_bounds__(kDqThreads, 1)
    dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
              const __grid_constant__ CUtensorMap k_map,
              const __grid_constant__ CUtensorMap v_map,
              const __grid_constant__ CUtensorMap do_map, Args a) {
  using C = Cfg<kD>;
  constexpr int kStages = C::kStages;
  constexpr int kTile = C::kTile;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);
  unsigned char* dOs = Qs + kTile;
  unsigned char* ring = dOs + kTile;                 // stage s: K, V
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * 2 * kTile);
  uint64_t* empty = full + kStages;
  uint64_t* qd_bar = empty + kStages;

  // the query tile varies slowest over the flat grid, the last (the most
  // keys, under a causal mask) first
  const int heads = a.Hq * a.B;
  const int qt = a.n_qt - 1 - static_cast<int>(blockIdx.x / heads);
  const int q0 = qt * kT;
  const int h = static_cast<int>(blockIdx.x % heads) % a.Hq;
  const int b = static_cast<int>(blockIdx.x % heads) / a.Hq;
  const int hk = h / (a.Hq / a.Hkv);

  // the key range any row of this tile sees, as in the forward
  const int q_last = min(q0 + kT, a.Sq) - 1;
  int k_end = a.Sk;
  if (a.causal) k_end = min(k_end, q_last + a.offset + 1);
  int k_begin = 0;
  if (a.window > 0) k_begin = max(0, q0 + a.offset - a.window + 1);
  k_begin = (k_begin / kT) * kT;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kT - 1) / kT : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    mbar_init(qd_bar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---------------- producer: one thread issues every load -------------
    if (threadIdx.x != 128 || n_tiles == 0) return;
    mbar_arrive_tx(qd_bar, 2 * kTile);
    for (int x = 0; x < C::kBoxes; ++x) {
      tma_load_4d(Qs + x * kBox, &q_map, qd_bar, 64 * x, q0, h, b);
      tma_load_4d(dOs + x * kBox, &do_map, qd_bar, 64 * x, q0, h, b);
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const int k0 = k_begin + t * kT;
      mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
      unsigned char* Kt = ring + s * 2 * kTile;
      mbar_arrive_tx(&full[s], 2 * kTile);
      for (int x = 0; x < C::kBoxes; ++x) {
        tma_load_4d(Kt + x * kBox, &k_map, &full[s], 64 * x, k0, hk, b);
        tma_load_4d(Kt + kTile + x * kBox, &v_map, &full[s], 64 * x, k0, hk,
                    b);
      }
    }
    return;
  }

  // ------------------------- consumer warpgroup ---------------------------
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float scale_log2 = a.scale * kLog2e;
  // this thread's rows (queries) r0 and r0 + 8 of the tile, their lse (in
  // log2 units) and Dsum; columns 8 j + c0, + 1 of every 8-column block
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
  const float* ld =
      a.ld + ((static_cast<long long>(b) * a.Hq + h) * a.n_qt + qt) * kLd;
  const float lse2[2] = {ld[r0], ld[r0 + 8]};
  const float dsum[2] = {ld[kT + r0], ld[kT + r0 + 8]};
  float acc[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) acc[i] = 0.f;
  if (n_tiles > 0) mbar_wait(qd_bar, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const int k0 = k_begin + t * kT;
    const unsigned char* Kt = ring + s * 2 * kTile;
    const unsigned char* Vt = Kt + kTile;
    const bool edge = crosses_edge(a, q0, k0);
    mbar_wait(&full[s], (t / kStages) & 1);
    // S = Q . K^T and dP = dO . V^T, two groups: P is made while dP's
    // products run
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    fence_operand(sc);
    fence_operand(dp);
    wgmma_fence();
    issue_nt<kD>(sc, Qs, Kt);
    wgmma_commit();
    issue_nt<kD>(dp, dOs, Vt);
    wgmma_commit();
    wgmma_wait<1>();
    fence_operand(sc);
    // P, masked on a tile across an edge
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        float x = fast_exp2(fmaf(sc[4 * j + e], scale_log2, -lse2[hh]));
        if (edge && !visible(a, q0 + r0 + 8 * hh, k0 + 8 * j + c0 + (e & 1)))
          x = 0.f;
        sc[4 * j + e] = x;
      }
    wgmma_wait<0>();
    fence_operand(dp);
    // dS = P o (dP - Dsum)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - dsum[e >> 1]);
    uint32_t f[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_frag(f[kk], dp, kk);
    mma_rs<kD>(acc, f, Kt);                // dQ += dS . K
    if (tid == 0) mbar_arrive(&empty[s]);
  }

  bf16* dqp = a.dq + (static_cast<long long>(b) * a.Hq + h) * a.Sq * a.D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = q0 + r0 + 8 * hh;
    if (i >= a.Sq) continue;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const int col = 8 * j + c0;
      if (col < a.D)
        *reinterpret_cast<__nv_bfloat162*>(
            dqp + static_cast<long long>(i) * a.D + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * hh] * a.scale,
                                  acc[4 * j + 2 * hh + 1] * a.scale);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int kD>
cudaError_t launch(const CUtensorMap* maps, const Args& a, cudaStream_t s) {
  using C = Cfg<kD>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = allow_smem(dkdv_wgmma_kernel<kD>, C::kDkdvSmem);
    if (err != cudaSuccess) return err;
    err = allow_smem(dq_wgmma_kernel<kD>, C::kDqSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const long long rows = static_cast<long long>(a.B) * a.Hq * a.n_qt * kT;
  const long long dkdv_ctas =
      static_cast<long long>((a.Sk + kT - 1) / kT) * a.Hkv * a.B;
  const long long dq_ctas = static_cast<long long>(a.n_qt) * a.Hq * a.B;
  if ((rows + 7) / 8 > 0x7fffffffLL || dkdv_ctas > 0x7fffffffLL ||
      dq_ctas > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (rows > 0) {
    ld_wgmma_kernel<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, s>>>(
        a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (dkdv_ctas > 0) {
    dkdv_wgmma_kernel<kD><<<static_cast<unsigned>(dkdv_ctas),
                            kDkdvThreads, C::kDkdvSmem, s>>>(
        maps[0], maps[1], maps[2], maps[3], a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (dq_ctas > 0)
    dq_wgmma_kernel<kD><<<static_cast<unsigned>(dq_ctas), kDqThreads,
                          C::kDqSmem, s>>>(maps[0], maps[1], maps[2],
                                           maps[3], a);
  return cudaGetLastError();
}

// a (B, H, S, D) bf16 tensor with element strides sb, sh, ss (D
// contiguous) in boxes of 64 rows x 64 columns; a tensor with no rows
// gets no map (the kernels then load none of it)
bool strided_map(CUtensorMap* map, const void* base, int B, int H, int S,
                 int D, long long sb, long long sh, long long ss) {
  if (S == 0) return true;
  const uint64_t dims[4] = {static_cast<uint64_t>(D),
                            static_cast<uint64_t>(S),
                            static_cast<uint64_t>(H),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {static_cast<uint64_t>(ss) * 2,
                               static_cast<uint64_t>(sh) * 2,
                               static_cast<uint64_t>(sb) * 2};
  const uint32_t box[4] = {64, kT, 1, 1};
  return bf16_map_strided(map, base, 4, dims, strides, box);
}

}  // namespace

extern "C" {

const char* flash_bwd_wgmma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The float32 scratch flash_attention_bwd_wgmma takes for (B, Hq, Sq):
// the lse/Dsum tiles, written to *floats.
int flash_bwd_wgmma_scratch_floats(int B, int Hq, int Sq, long long* floats) {
  if (B < 0 || Hq < 0 || Sq < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  *floats = static_cast<long long>(B) * Hq * ((Sq + kT - 1) / kT) * kLd;
  return 0;
}

// The wgmma route: bfloat16 q, k, v, out and dout, D % 8 == 0 and 128 < D
// <= 256, every element stride (batch, head, sequence) a multiple of 8 and
// every base on 16 bytes (the wrapper checks both); lse (B, Hq, Sq)
// float32.  `scratch` is float32, as many floats as
// flash_bwd_wgmma_scratch_floats says.  The arguments are
// flash_attention_bwd_mma's.
int flash_attention_bwd_wgmma(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* scratch, void* dq, void* dk,
    void* dv, int B, int Hq, int Hkv, int Sq, int Sk, int D, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, long long do_sb,
    long long do_sh, long long do_ss, float scale, int causal, int window,
    int offset, void* stream) {
  if (D <= 128 || D > 256 || D % 8 != 0 || Hkv < 1 || Hq % Hkv != 0 ||
      B < 0 || Sq < 0 || Sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long strides[15] = {q_sb, q_sh, q_ss, k_sb,  k_sh,
                                 k_ss, v_sb, v_sh, v_ss,  o_sb,
                                 o_sh, o_ss, do_sb, do_sh, do_ss};
  for (const long long st : strides)
    if (st % 8 != 0 || st < 0) return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[9] = {q, k, v, out, dout, dq, dk, dv, scratch};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
  if (B == 0 || Hq == 0) return 0;
  const Args a{static_cast<const bf16*>(out),
               static_cast<const bf16*>(dout),
               lse,
               scratch,
               static_cast<bf16*>(dq),
               static_cast<bf16*>(dk),
               static_cast<bf16*>(dv),
               B, Hq, Hkv, Sq, Sk, D,
               o_sb, o_sh, o_ss, do_sb, do_sh, do_ss,
               scale, causal, window, offset, (Sq + kT - 1) / kT};
  CUtensorMap maps[4] = {};     // q, k, v, dout
  if (!strided_map(&maps[0], q, B, Hq, Sq, D, q_sb, q_sh, q_ss) ||
      !strided_map(&maps[1], k, B, Hkv, Sk, D, k_sb, k_sh, k_ss) ||
      !strided_map(&maps[2], v, B, Hkv, Sk, D, v_sb, v_sh, v_ss) ||
      !strided_map(&maps[3], dout, B, Hq, Sq, D, do_sb, do_sh, do_ss))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 192) return static_cast<int>(launch<192>(maps, a, s));
  return static_cast<int>(launch<256>(maps, a, s));
}

}  // extern "C"
