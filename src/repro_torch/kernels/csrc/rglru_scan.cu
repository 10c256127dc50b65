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
// blocks.
//
// Bound: device-memory bytes.  x and log_a are read once and y is written
// once (141.6 MB at the serving shape B = 4, S = 2304, D = 2560 in bf16,
// 0.042 ms at 3.35 TB/s).  The arithmetic is near it: a float64
// exponential (decay() below), a square root, the update and the chunked
// form's products come to a few dozen instructions an element, so the
// SMs' instruction rate and their float64 rate are the second limit.
// One thread per channel that walks all of time, as a plain port would,
// gives only B * D threads (320 warps at the serving shape), each waiting
// on its own loads: latency, not bytes, then bounds it.  So the scan is
// chunked in time inside a block, and reads memory in one pass:
//
// - A block owns kC = 32 channels of one batch row, one a lane, and walks
//   time in tiles of kT steps (128 in bf16, 64 in float32: 16 KB of x and
//   log_a).  Tiles come into shared memory through a ring of two stages by
//   16-byte cp.async copies, so the next tile is in flight while one is
//   scanned: about 5 MB in flight over the card at the serving shape.
//   More stages, or larger tiles, were slower on the card.
// - Within a tile, warp w takes steps w*kK .. w*kK + kK - 1 (kK = kT / 8)
//   and scans them from h = 0, keeping for each step its local state hl_t
//   and the running product A_t = prod a of its run in registers; it
//   publishes its run's end pair (A_end, h_end) in shared memory.
// - After a barrier, each thread folds the end pairs of the warps before
//   its own into the carry from the previous tile (h_in <- A_end * h_in +
//   h_end, at most kW = 8 fused multiply-adds), writes y_t = hl_t + A_t *
//   h_in over its x in shared memory, and folds the rest into the next
//   tile's carry.  The serial chain a tile is kK + kW steps, not kT.
// - The tile of y leaves in 16-byte stores from shared memory.
// - Given a carries buffer (training: RGLRUScan), warp 0 also stores the
//   carry before each tile, the float32 state the backward starts its
//   tile from (B x ceil(S / kT) x D floats, 1/64 of x's bytes in bf16);
//   serving passes none and stores nothing more.
//
// A_t is a product of a, not the exp of a sum: with log_a <= 0 nothing
// overflows, strong decays underflow to 0 as in the sequential form, and
// log_a = 0 (a = 1, gate 0) carries h exactly.  The decay terms are
// decay()'s, the plain version's formula (kernels/ref.py::_rglru_decay) on
// every device: exp(log_a) taken in float64 and rounded once to float32,
// and exp(2 log_a) as its square in float64, rounded once.  1 - exp(2
// log_a) cancels near log_a = 0, which would magnify a float32
// exponential's few-ulp error by 1 / (1 - exp(2 log_a)); rounded once,
// both sides take the same a and the same difference.  The square root
// is the hardware's (sqrt.approx, relative error ~2^-23), without
// sqrtf's slow path.  Steps past S and channels past D load as
// zeros (a = 1, gate 0: the state carries through them unchanged) and are
// not stored; nothing is padded in memory.  Rows that do not start on 16
// bytes (D * sizeof % 16 != 0, or a base address off 16 bytes) take the
// same kernel with one-element copies (kVec16 = false;
// kernels/rglru_scan.py::_variant picks).  Against a decoupled look-back
// over a grid split in time, this needs no flags in device memory and no
// second device operation, and the B * D / kC blocks (320 at the serving
// shape, three an SM at most) are all resident at once.  x, log_a and y
// are contiguous; the C entry points launch on the caller's stream,
// allocate nothing and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kC = 32;           // channels a block, one a lane
constexpr int kW = 8;            // warps a block
constexpr int kThreads = kW * 32;

template <typename T>
struct Smem {
  static constexpr int kK = sizeof(T) == 2 ? 16 : 8;  // steps a warp scans
  static constexpr int kT = kW * kK;                   // steps a tile
  static constexpr int kStages = 2;
  T x[kStages][kT][kC];  // a tile of x, then of y once it is scanned
  T la[kStages][kT][kC];
  float end_a[kW][kC];   // each warp's run: the product of its a
  float end_h[kW][kC];   // and its last state, from h = 0
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float& p, float v) { p = v; }
__device__ __forceinline__ void put(__nv_bfloat16& p, float v) {
  p = __float2bfloat16(v);
}

// the hardware's square root (one MUFU.SQRT, ~1 ulp; sqrt(0) = 0), in place
// of sqrtf's correctly rounded one and its slow path
__device__ __forceinline__ float sqrt_approx(float v) {
  float r;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// The decay terms of one step, on every device as the plain version takes
// them (kernels/ref.py::_rglru_decay): a = exp(log_a) in float64, rounded
// once to float32, and the gate sqrt(max(1 - exp(2 log_a), 0)) from
// exp(2 log_a) = exp(log_a)^2 in float64, rounded once, the difference
// and the square root in float32.  One float64 exponential a step.
struct Decay {
  float a, gate;
};
__device__ __forceinline__ Decay decay(float log_a) {
  const double e = exp(static_cast<double>(log_a));
  return {static_cast<float>(e),
          sqrt_approx(fmaxf(1.f - static_cast<float>(e * e), 0.f))};
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

// Steps t0 .. t0 + kT - 1 of channels d0 .. d0 + kC - 1 of one batch row
// of one array (g points at the row's step 0) into one stage; steps past S
// and channels past D as zeros.  kVec16: 16-byte cp.async copies (D *
// sizeof a multiple of 16, so a copy lies wholly inside D or wholly past
// it), else one element a thread at a time, as raw bits.
template <typename T, bool kVec16>
__device__ __forceinline__ void load_rows(T (*sg)[kC], const T* g, int t0,
                                          int d0, int S, int D) {
  constexpr int kT = Smem<T>::kT;
  if constexpr (kVec16) {
    constexpr int kV = 16 / sizeof(T), kP = kC / kV;
#pragma unroll
    for (int j = 0; j < kT * kP / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / kP, c = i % kP * kV;
      const bool ok = t0 + r < S && d0 + c < D;
      const long long o = ok ? static_cast<long long>(t0 + r) * D + d0 + c
                             : 0;
      cp_async16(&sg[r][c], g + o, ok);
    }
  } else {
    using Bits = std::conditional_t<sizeof(T) == 2, uint16_t, uint32_t>;
#pragma unroll 4
    for (int j = 0; j < kT * kC / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / kC, c = i % kC;
      const bool ok = t0 + r < S && d0 + c < D;
      const long long o = static_cast<long long>(t0 + r) * D + d0 + c;
      reinterpret_cast<Bits&>(sg[r][c]) =
          ok ? reinterpret_cast<const Bits*>(g)[o] : Bits(0);
    }
  }
}

// The same steps of x and la.
template <typename T, bool kVec16>
__device__ __forceinline__ void load_tile(T (*sx)[kC], T (*sla)[kC],
                                          const T* x, const T* la, int t0,
                                          int d0, int S, int D) {
  load_rows<T, kVec16>(sx, x, t0, d0, S, D);
  load_rows<T, kVec16>(sla, la, t0, d0, S, D);
}

// A tile of y from shared memory to steps t0 .. of channels d0 .. of one
// batch row, those below S and D.
template <typename T, bool kVec16>
__device__ __forceinline__ void store_tile(T* y, const T (*sy)[kC], int t0,
                                           int d0, int S, int D) {
  constexpr int kT = Smem<T>::kT;
  if constexpr (kVec16) {
    constexpr int kV = 16 / sizeof(T), kP = kC / kV;
#pragma unroll
    for (int j = 0; j < kT * kP / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / kP, c = i % kP * kV;
      if (t0 + r < S && d0 + c < D)
        *reinterpret_cast<uint4*>(y + static_cast<long long>(t0 + r) * D +
                                  d0 + c) =
            *reinterpret_cast<const uint4*>(&sy[r][c]);
    }
  } else {
#pragma unroll 4
    for (int j = 0; j < kT * kC / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / kC, c = i % kC;
      if (t0 + r < S && d0 + c < D)
        y[static_cast<long long>(t0 + r) * D + d0 + c] = sy[r][c];
    }
  }
}

template <typename T, bool kVec16>
__global__ void __launch_bounds__(kThreads, 3)
    rglru_tile_kernel(const T* __restrict__ x, const T* __restrict__ la,
                      T* __restrict__ y, float* __restrict__ h_out,
                      float* __restrict__ carries, int S, int D) {
  using L = Smem<T>;
  constexpr int kK = L::kK, kT = L::kT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  L& sm = *reinterpret_cast<L*>(smem_raw);
  const int w = threadIdx.x / 32, c = threadIdx.x % 32;
  const int d0 = blockIdx.x * kC, b = blockIdx.y;
  const long long row = static_cast<long long>(b) * S * D;
  x += row;
  la += row;
  y += row;
  const int n_tiles = (S + kT - 1) / kT;

#pragma unroll
  for (int s = 0; s < L::kStages - 1; ++s) {
    if (s < n_tiles)
      load_tile<T, kVec16>(sm.x[s], sm.la[s], x, la, s * kT, d0, S, D);
    cp_async_commit();
  }
  float carry = 0.f;  // the state before the tile, of channel d0 + c
  for (int i = 0; i < n_tiles; ++i) {
    // tile i is in; every thread is past tile i - 1, whose stage (y
    // stored) takes tile i + kStages - 1
    cp_async_wait<L::kStages - 2>();
    __syncthreads();
    const int next = i + L::kStages - 1;
    if (next < n_tiles)
      load_tile<T, kVec16>(sm.x[next % L::kStages], sm.la[next % L::kStages],
                           x, la, next * kT, d0, S, D);
    cp_async_commit();

    if (carries != nullptr && w == 0 && d0 + c < D)
      carries[(static_cast<long long>(b) * n_tiles + i) * D + d0 + c] = carry;
    T(*sx)[kC] = sm.x[i % L::kStages];
    const T(*sla)[kC] = sm.la[i % L::kStages];
    float hl[kK], ap[kK];
    float h = 0.f, A = 1.f;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const Decay dc = decay(to_f(sla[w * kK + k][c]));
      h = dc.a * h + dc.gate * to_f(sx[w * kK + k][c]);
      A *= dc.a;
      hl[k] = h;
      ap[k] = A;
    }
    sm.end_a[w][c] = A;
    sm.end_h[w][c] = h;
    __syncthreads();
    float h_in = 0.f;
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      if (j == w) h_in = carry;
      carry = fmaf(sm.end_a[j][c], carry, sm.end_h[j][c]);
    }
#pragma unroll
    for (int k = 0; k < kK; ++k)
      put(sx[w * kK + k][c], fmaf(ap[k], h_in, hl[k]));
    __syncthreads();
    store_tile<T, kVec16>(y, sx, i * kT, d0, S, D);
  }
  if (w == 0 && d0 + c < D)
    h_out[static_cast<long long>(b) * D + d0 + c] = carry;
}

template <typename T, bool kVec16>
cudaError_t launch(const void* x, const void* la, void* y, float* h_final,
                   float* carries, int B, int S, int D, cudaStream_t s) {
  constexpr int kSmem = sizeof(Smem<T>);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        rglru_tile_kernel<T, kVec16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((D + kC - 1) / kC, B);
  rglru_tile_kernel<T, kVec16><<<grid, kThreads, kSmem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(la),
      static_cast<T*>(y), h_final, carries, S, D);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the backward (rglru_scan_bwd)
// ---------------------------------------------------------------------------
//
// No TPU kernel: the reference trains through jax.vjp of kref.rglru
// (src/repro/kernels/ref.py), and this is that vjp.  With g_t the gradient
// of h_t and b_t = sqrt(max(1 - a_t^2, 0)):
//
//   g_t      = dy_t + a_{t+1} g_{t+1},   g_{S-1} = dy_{S-1} + dh_final
//   dx_t     = b_t g_t
//   dlog_a_t = g_t (a_t h_{t-1} - a_t^2 x_t / b_t)   (the gate's term 0
//                                                      where b_t = 0)
//
// The reverse recurrence is linear with the forward's coefficients: with
// e_t = a_t g_t (what step t hands to step t - 1), e_t = a_t (dy_t +
// e_{t+1}) from e_S = dh_final, and g_t = dy_t + e_{t+1}.
//
// Bound: device-memory bytes.  x, log_a and dy are read and dx and dlog_a
// written once: 10 bytes an element in bf16, 210 MB at recurrentgemma-2b's
// training shape B = 2, S = 4096, D = 2560 (0.063 ms at 3.35 TB/s).  A
// block that walks all of time for its channels (one a 32 channels and
// batch row: 160 blocks at that shape, each with every tile in series)
// waits on its own loads, so the work is cut by tile and done for every
// tile at once, in two kernels over a grid of (32-channel group, range of
// tiles, b), each block taking its range's tiles behind a ring of two
// stages (the next tile loads while one is scanned):
//
// - rglru_bwd_agg_kernel reads a tile's log_a and dy.  Each warp scans its
//   run of kK steps back from e = 0, keeping the run's product of a; warp
//   0 folds the runs' end pairs, last first, into the tile's aggregate:
//   P_i = prod a over the tile and eps_i, e at its first step from e = 0
//   after it.  2 floats a tile and channel of scratch (1.3 MB at that
//   shape); tile 0's is never needed and not computed.
// - rglru_bwd_grad_kernel takes its range's tiles from the last to the
//   first.  Warp 0 folds dh_final through the aggregates of the tiles after
//   the range, last first, for e after its last tile, then one aggregate
//   more a tile (e <- P_j e + eps_j: one fixed order, no atomics, two calls
//   bitwise equal), and takes h before each tile from the forward's
//   carries (the float32 state it kept, so nothing is rebuilt from y,
//   which is rounded to the input type), while the tile of x, log_a and dy
//   comes in by cp.async.  Each warp scans its run forward from h = 0 and
//   back from e = 0 for the end pairs, the runs are folded into each run's
//   h_in and e_in, and each warp then runs its steps forward from h_in
//   (h_{t-1}) and back from e_in (g_t), writing dx and dlog_a over the
//   tile's x and log_a in shared memory; they leave in 16-byte stores.
//   The decay terms, one float64 exponential a step, are decay()'s, as the
//   forward's, and stay in registers between the scans; a^2 x / b, which
//   grows as b -> 0 (log_a -> 0, where 1 - exp(2 log_a) cancels), is that
//   of the forward's gate, its quotient the hardware's reciprocal times
//   the numerator (__fdividef, ~2 ulp, without IEEE division's slow
//   path).  Its grid runs in the reverse of the
//   aggregates kernel's order, so its first blocks find in L2 the log_a
//   and dy that kernel read last.
//
// Traffic: log_a and dy once for the aggregates, then x, log_a and dy
// read and dx and dlog_a written, 14 bytes an element in bf16, and no
// walk over time beyond a range of tiles and the fold of the aggregates
// (L2 reads).  Steps past S (a = 1, gate 0, dy = 0) carry e unchanged;
// channels past D are not stored.

// Tiles a backward block takes (a ring of two stages: the next tile loads
// while one is scanned) and the gradient kernel's blocks an SM.
constexpr int kAggTiles = 2;
constexpr int kGradTiles = 4;
constexpr int kGradBlocks = 3;

template <typename T>
struct SmemAgg {
  static constexpr int kStages = 2;
  T la[kStages][Smem<T>::kT][kC];
  T dy[kStages][Smem<T>::kT][kC];
  float end_p[kW][kC];  // each warp's run backward: the product of its a
  float end_e[kW][kC];  // and e at its first step, from e = 0 after it
};

template <typename T>
struct SmemBwd {
  static constexpr int kStages = 2;
  T x[kStages][Smem<T>::kT][kC];   // x, then dx
  T la[kStages][Smem<T>::kT][kC];  // log_a, then dlog_a
  T dy[kStages][Smem<T>::kT][kC];
  float end_a[kW][kC];  // each warp's run forward: the product of its a
  float end_h[kW][kC];  // and its last state, from h = 0
  float end_p[kW][kC];  // backward: the product of its a
  float end_e[kW][kC];  // and e at its first step, from e = 0 after it
  float h_tile[kC];     // the state before the tile
  float e_tile[kC];     // e at the first step after the tile
};

// The tiles i_lo .. i_hi of block row y, kTiles a block.
template <int kTiles>
__device__ __forceinline__ void block_tiles(int y, int n_tiles, int& i_lo,
                                            int& i_hi) {
  i_lo = y * kTiles;
  i_hi = min(i_lo + kTiles, n_tiles) - 1;
}

// aggs[b, i, 0, d] = P_i, aggs[b, i, 1, d] = eps_i, for tiles i >= 1
template <typename T, bool kVec16>
__global__ void __launch_bounds__(kThreads, 4)
    rglru_bwd_agg_kernel(const T* __restrict__ la, const T* __restrict__ dy,
                         float* __restrict__ aggs, int n_tiles, int S,
                         int D) {
  using L = SmemAgg<T>;
  constexpr int kK = Smem<T>::kK, kT = Smem<T>::kT;
  int i_lo, i_hi;
  block_tiles<kAggTiles>(blockIdx.y, n_tiles, i_lo, i_hi);
  i_lo = max(i_lo, 1);  // no tile before tile 0 reads its aggregate
  if (i_lo > i_hi) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  L& sm = *reinterpret_cast<L*>(smem_raw);
  const int w = threadIdx.x / 32, c = threadIdx.x % 32;
  const int d0 = blockIdx.x * kC, b = blockIdx.z, d = d0 + c;
  const long long row = static_cast<long long>(b) * S * D;
  la += row;
  dy += row;
  load_rows<T, kVec16>(sm.la[0], la, i_lo * kT, d0, S, D);
  load_rows<T, kVec16>(sm.dy[0], dy, i_lo * kT, d0, S, D);
  cp_async_commit();
  for (int i = i_lo; i <= i_hi; ++i) {
    const int st = (i - i_lo) % L::kStages;
    // tile i is in; every thread is past tile i - 1, whose stage takes
    // tile i + 1
    cp_async_wait<0>();
    __syncthreads();
    if (i < i_hi) {
      const int sn = (i + 1 - i_lo) % L::kStages;
      load_rows<T, kVec16>(sm.la[sn], la, (i + 1) * kT, d0, S, D);
      load_rows<T, kVec16>(sm.dy[sn], dy, (i + 1) * kT, d0, S, D);
    }
    cp_async_commit();
    float e = 0.f, P = 1.f;
#pragma unroll
    for (int k = kK - 1; k >= 0; --k) {
      const float a = decay(to_f(sm.la[st][w * kK + k][c])).a;
      e = a * (to_f(sm.dy[st][w * kK + k][c]) + e);
      P *= a;
    }
    sm.end_p[w][c] = P;
    sm.end_e[w][c] = e;
    __syncthreads();
    if (w == 0 && d < D) {
      float ep = 0.f, pp = 1.f;
#pragma unroll
      for (int j = kW - 1; j >= 0; --j) {
        ep = fmaf(sm.end_p[j][c], ep, sm.end_e[j][c]);
        pp *= sm.end_p[j][c];
      }
      float* ag = aggs + (static_cast<long long>(b) * n_tiles + i) * 2 * D;
      ag[d] = pp;
      ag[D + d] = ep;
    }
  }
}

template <typename T, bool kVec16>
__global__ void __launch_bounds__(kThreads, kGradBlocks)
    rglru_bwd_grad_kernel(const T* __restrict__ x, const T* __restrict__ la,
                          const T* __restrict__ dy,
                          const float* __restrict__ dh_final,
                          const float* __restrict__ carries,
                          const float* __restrict__ aggs, T* __restrict__ dx,
                          T* __restrict__ dla, int n_tiles, int S, int D) {
  using L = SmemBwd<T>;
  constexpr int kK = Smem<T>::kK, kT = Smem<T>::kT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  L& sm = *reinterpret_cast<L*>(smem_raw);
  // rows in the reverse of the aggregates kernel's order, so the first
  // blocks find in L2 the log_a and dy it read last
  const int w = threadIdx.x / 32, c = threadIdx.x % 32;
  const int d0 = blockIdx.x * kC, b = gridDim.z - 1 - blockIdx.z, d = d0 + c;
  int i_lo, i_hi;
  block_tiles<kGradTiles>(gridDim.y - 1 - blockIdx.y, n_tiles, i_lo, i_hi);
  const long long row = static_cast<long long>(b) * S * D;
  x += row;
  la += row;
  dy += row;
  dx += row;
  dla += row;
  // the block's tiles from its last to its first
  load_tile<T, kVec16>(sm.x[0], sm.la[0], x, la, i_hi * kT, d0, S, D);
  load_rows<T, kVec16>(sm.dy[0], dy, i_hi * kT, d0, S, D);
  cp_async_commit();
  // warp 0, lane c: e after the tile and h before it, for channel d
  const float* ag = aggs + static_cast<long long>(b) * n_tiles * 2 * D + d;
  const float* car = carries + static_cast<long long>(b) * n_tiles * D + d;
  float e = 0.f, h_next = 0.f;
  if (w == 0 && d < D) {  // dh_final folded through the later tiles'
                          // aggregates, the last first
    e = dh_final != nullptr ? dh_final[static_cast<long long>(b) * D + d]
                            : 0.f;
#pragma unroll 8
    for (int j = n_tiles - 1; j > i_hi; --j)
      e = fmaf(ag[2LL * j * D], e, ag[(2LL * j + 1) * D]);
    h_next = car[static_cast<long long>(i_hi) * D];
  }
  for (int i = i_hi; i >= i_lo; --i) {
    const int st = (i_hi - i) % L::kStages;
    if (w == 0) {
      sm.e_tile[c] = e;
      sm.h_tile[c] = h_next;
    }
    // tile i is in; every thread is past tile i + 1, whose stage takes
    // tile i - 1
    cp_async_wait<0>();
    __syncthreads();
    if (i > i_lo) {
      const int sn = (i_hi - i + 1) % L::kStages;
      load_tile<T, kVec16>(sm.x[sn], sm.la[sn], x, la, (i - 1) * kT, d0, S,
                           D);
      load_rows<T, kVec16>(sm.dy[sn], dy, (i - 1) * kT, d0, S, D);
      if (w == 0 && d < D) {  // e after tile i - 1, h before it
        e = fmaf(ag[2LL * i * D], e, ag[(2LL * i + 1) * D]);
        h_next = car[static_cast<long long>(i - 1) * D];
      }
    }
    cp_async_commit();

    T(*sx)[kC] = sm.x[st];
    T(*sla)[kC] = sm.la[st];
    const T(*sdy)[kC] = sm.dy[st];
    float av[kK], gv[kK];  // the run's decay terms
    float h = 0.f, A = 1.f;
#pragma unroll
    for (int k = 0; k < kK; ++k) {  // the run forward from h = 0
      const Decay dc = decay(to_f(sla[w * kK + k][c]));
      av[k] = dc.a;
      gv[k] = dc.gate;
      h = dc.a * h + dc.gate * to_f(sx[w * kK + k][c]);
      A *= dc.a;
    }
    float eb = 0.f, P = 1.f;
#pragma unroll
    for (int k = kK - 1; k >= 0; --k) {  // and backward from e = 0
      eb = av[k] * (to_f(sdy[w * kK + k][c]) + eb);
      P *= av[k];
    }
    sm.end_a[w][c] = A;
    sm.end_h[w][c] = h;
    sm.end_p[w][c] = P;
    sm.end_e[w][c] = eb;
    __syncthreads();
    float h_in = 0.f, hc = sm.h_tile[c];
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      if (j == w) h_in = hc;
      hc = fmaf(sm.end_a[j][c], hc, sm.end_h[j][c]);
    }
    float e_in = 0.f, ec = sm.e_tile[c];  // e at the first step after the
#pragma unroll                            // run
    for (int j = kW - 1; j >= 0; --j) {
      if (j == w) e_in = ec;
      ec = fmaf(sm.end_p[j][c], ec, sm.end_e[j][c]);
    }
    float hp[kK];  // h_{t-1}
    h = h_in;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      hp[k] = h;
      h = av[k] * h + gv[k] * to_f(sx[w * kK + k][c]);
    }
    eb = e_in;
#pragma unroll
    for (int k = kK - 1; k >= 0; --k) {
      const int t = w * kK + k;
      const float a = av[k], gate = gv[k], xv = to_f(sx[t][c]);
      const float g = to_f(sdy[t][c]) + eb;
      const float q = gate > 0.f ? __fdividef(a * a * xv, gate) : 0.f;
      put(sx[t][c], gate * g);
      put(sla[t][c], g * (a * hp[k] - q));
      eb = a * g;
    }
    __syncthreads();
    store_tile<T, kVec16>(dx, sx, i * kT, d0, S, D);
    store_tile<T, kVec16>(dla, sla, i * kT, d0, S, D);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, bool kVec16>
cudaError_t launch_bwd(const void* x, const void* la, const void* dy,
                       const float* dh_final, const float* carries,
                       float* aggs, void* dx, void* dla, int B, int S, int D,
                       cudaStream_t s) {
  constexpr int kAgg = sizeof(SmemAgg<T>), kGrad = sizeof(SmemBwd<T>);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = allow_smem(rglru_bwd_agg_kernel<T, kVec16>, kAgg);
    if (err == cudaSuccess)
      err = allow_smem(rglru_bwd_grad_kernel<T, kVec16>, kGrad);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int n_tiles = (S + Smem<T>::kT - 1) / Smem<T>::kT;
  const int groups = (D + kC - 1) / kC;
  rglru_bwd_agg_kernel<T, kVec16><<<
      dim3(groups, (n_tiles + kAggTiles - 1) / kAggTiles, B), kThreads, kAgg,
      s>>>(static_cast<const T*>(la), static_cast<const T*>(dy), aggs,
           n_tiles, S, D);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rglru_bwd_grad_kernel<T, kVec16><<<
      dim3(groups, (n_tiles + kGradTiles - 1) / kGradTiles, B), kThreads,
      kGrad, s>>>(static_cast<const T*>(x), static_cast<const T*>(la),
                  static_cast<const T*>(dy), dh_final, carries, aggs,
                  static_cast<T*>(dx), static_cast<T*>(dla), n_tiles, S, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* rglru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16 (x, log_a and y alike); h_final float32.
// vec16: 1 if every row of x, log_a and y starts on 16 bytes (16-byte
// copies), 0 for one-element copies.  carries: null, or float32 (B,
// ceil(S / kT), D) for the state before each tile (kT = 128 in bf16, 64
// in float32), which the backward takes.
int rglru_scan_fwd(int dtype, int vec16, const void* x, const void* log_a,
                   void* y, float* h_final, float* carries, int B, int S,
                   int D, void* stream) {
  if (B < 0 || S < 0 || D < 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || D == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = vec16 ? launch<float, true>(x, log_a, y, h_final, carries, B, S, D,
                                      s)
                : launch<float, false>(x, log_a, y, h_final, carries, B, S,
                                       D, s);
  else if (dtype == 1)
    err = vec16 ? launch<__nv_bfloat16, true>(x, log_a, y, h_final, carries,
                                              B, S, D, s)
                : launch<__nv_bfloat16, false>(x, log_a, y, h_final, carries,
                                               B, S, D, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// The backward: dx, dlog_a (the dtype of x, log_a and dy) from dy and
// dh_final (float32 (B, D), or null for zero); carries: the forward's
// float32 (B, ceil(S / kT), D) tile states; aggs: float32 scratch of B *
// ceil(S / kT) * 2 * D.  vec16: 1 if every row of x, log_a, dy, dx and
// dlog_a starts on 16 bytes.  Two launches; none for S = 0.
int rglru_scan_bwd(int dtype, int vec16, const void* x, const void* log_a,
                   const void* dy, const float* dh_final,
                   const float* carries, float* aggs, void* dx, void* dlog_a,
                   int B, int S, int D, void* stream) {
  const int tile = dtype == 1 ? 128 : 64;
  if (B < 0 || S < 0 || D < 0 || B > 65535 || (S + tile - 1) / tile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0 || D == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = vec16 ? launch_bwd<float, true>(x, log_a, dy, dh_final, carries,
                                          aggs, dx, dlog_a, B, S, D, s)
                : launch_bwd<float, false>(x, log_a, dy, dh_final, carries,
                                           aggs, dx, dlog_a, B, S, D, s);
  else if (dtype == 1)
    err = vec16 ? launch_bwd<__nv_bfloat16, true>(x, log_a, dy, dh_final,
                                                  carries, aggs, dx, dlog_a,
                                                  B, S, D, s)
                : launch_bwd<__nv_bfloat16, false>(x, log_a, dy, dh_final,
                                                   carries, aggs, dx, dlog_a,
                                                   B, S, D, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
