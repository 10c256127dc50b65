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
// 0.042 ms at 3.35 TB/s).  The arithmetic is near it: two exponentials, a
// square root, the update and the chunked form's products come to a few
// dozen instructions an element, so the SMs' issue rate is the second
// limit.
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
//
// A_t is a product of a, not the exp of a sum: with log_a <= 0 nothing
// overflows, strong decays underflow to 0 as in the sequential form, and
// log_a = 0 (a = 1, gate 0) carries h exactly.  Both exponentials are
// expf, rounded as the plain version's: 1 - exp(2 log_a) cancels near
// log_a = 0, which would magnify a cheaper exponential's few-ulp error by
// 1 / (1 - exp(2 log_a)); the square root is the hardware's (sqrt.approx, relative error ~2^-23),
// without sqrtf's slow path.  Steps past S and channels past D load as
// zeros (a = 1, gate 0: the state carries through them unchanged) and are
// not stored; nothing is padded in memory.  Rows that do not start on 16
// bytes (D * sizeof % 16 != 0, or a base address off 16 bytes) take the
// same kernel with one-element copies (kVec16 = false;
// kernels/rglru_scan.py::_variant picks).  Against a decoupled look-back
// over a grid split in time, this needs no flags in device memory and no
// second device operation, and the B * D / kC blocks (320 at the serving
// shape, three an SM at most) are all resident at once.  x, log_a and y
// are contiguous; the C entry point launches on the caller's stream,
// allocates nothing and returns cudaGetLastError().

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
                      T* __restrict__ y, float* __restrict__ h_out, int S,
                      int D) {
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

    T(*sx)[kC] = sm.x[i % L::kStages];
    const T(*sla)[kC] = sm.la[i % L::kStages];
    float hl[kK], ap[kK];
    float h = 0.f, A = 1.f;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const float lv = to_f(sla[w * kK + k][c]);
      const float a = expf(lv);
      const float gate = sqrt_approx(fmaxf(1.f - expf(2.f * lv), 0.f));
      h = a * h + gate * to_f(sx[w * kK + k][c]);
      A *= a;
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
                   int B, int S, int D, cudaStream_t s) {
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
      static_cast<T*>(y), h_final, S, D);
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
// e_{t+1}) from e_S = dh_final, and g_t = dy_t + e_{t+1}.  So the
// forward's tiling runs backward in time: 32 channels a block, tiles of x,
// log_a and dy through a two-stage cp.async ring from the last tile to the
// first, each warp scanning its run of kK steps back from e = 0 (local e
// and the run's products of a), the runs folded by their end pairs into
// the carry from the tile after.  h_{t-1} is never rebuilt from y, which
// is rounded to the input type: a first pass walks the tiles forward and
// keeps the float32 state before each (B x ceil(S / kT) x D floats of
// scratch, 0.66 MB at recurrentgemma-2b's training shape B = 2, S = 4096,
// D = 2560), and the second pass rescans each tile's runs forward from
// that state beside the backward scan.  The exponentials and the square
// root are the forward's (expf, sqrt.approx), so the card's forward and
// backward take the same a and b, and a^2 x / b, which grows as b -> 0
// (log_a -> 0, where 1 - exp(2 log_a) cancels), is that of the forward's
// gate.  dx and dlog_a go out through the tile's x and log_a slots.
//
// Bound: device-memory bytes.  x, log_a and dy are read and dx and dlog_a
// written once: 10 bytes an element in bf16, 210 MB at the training shape
// (0.063 ms at 3.35 TB/s); the first pass reads x and log_a once more.

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
};

template <typename T, bool kVec16>
__global__ void __launch_bounds__(kThreads, 2)
    rglru_bwd_kernel(const T* __restrict__ x, const T* __restrict__ la,
                     const T* __restrict__ dy,
                     const float* __restrict__ dh_final, T* __restrict__ dx,
                     T* __restrict__ dla, float* __restrict__ carries, int S,
                     int D) {
  using L = SmemBwd<T>;
  constexpr int kK = Smem<T>::kK, kT = Smem<T>::kT, kStages = L::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  L& sm = *reinterpret_cast<L*>(smem_raw);
  const int w = threadIdx.x / 32, c = threadIdx.x % 32;
  const int d0 = blockIdx.x * kC, b = blockIdx.y, d = d0 + c;
  const long long row = static_cast<long long>(b) * S * D;
  x += row;
  la += row;
  dy += row;
  dx += row;
  dla += row;
  const int n_tiles = (S + kT - 1) / kT;
  float* car = carries + static_cast<long long>(b) * n_tiles * D;

  // pass 1: the float32 state before each tile, tiles in order
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles)
      load_tile<T, kVec16>(sm.x[s], sm.la[s], x, la, s * kT, d0, S, D);
    cp_async_commit();
  }
  float carry = 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = i + kStages - 1;
    if (next < n_tiles)
      load_tile<T, kVec16>(sm.x[next % kStages], sm.la[next % kStages], x,
                           la, next * kT, d0, S, D);
    cp_async_commit();
    const T(*sx)[kC] = sm.x[i % kStages];
    const T(*sla)[kC] = sm.la[i % kStages];
    float h = 0.f, A = 1.f;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const float lv = to_f(sla[w * kK + k][c]);
      const float a = expf(lv);
      const float gate = sqrt_approx(fmaxf(1.f - expf(2.f * lv), 0.f));
      h = a * h + gate * to_f(sx[w * kK + k][c]);
      A *= a;
    }
    sm.end_a[w][c] = A;
    sm.end_h[w][c] = h;
    __syncthreads();
    if (w == 0 && d < D) car[static_cast<long long>(i) * D + d] = carry;
#pragma unroll
    for (int j = 0; j < kW; ++j)
      carry = fmaf(sm.end_a[j][c], carry, sm.end_h[j][c]);
  }
  cp_async_wait<0>();
  __syncthreads();  // pass 1's stages are free, its carries visible

  // pass 2: tiles from the last to the first
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) {
      const int t0 = (n_tiles - 1 - s) * kT;
      load_tile<T, kVec16>(sm.x[s], sm.la[s], x, la, t0, d0, S, D);
      load_rows<T, kVec16>(sm.dy[s], dy, t0, d0, S, D);
    }
    cp_async_commit();
  }
  // e at the first step after the tile: e_S = dh_final
  float e_tile = dh_final != nullptr && d < D
                     ? dh_final[static_cast<long long>(b) * D + d]
                     : 0.f;
  for (int it = 0; it < n_tiles; ++it) {
    const int i = n_tiles - 1 - it, st = it % kStages;
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = it + kStages - 1;
    if (next < n_tiles) {
      const int t0 = (n_tiles - 1 - next) * kT, sn = next % kStages;
      load_tile<T, kVec16>(sm.x[sn], sm.la[sn], x, la, t0, d0, S, D);
      load_rows<T, kVec16>(sm.dy[sn], dy, t0, d0, S, D);
    }
    cp_async_commit();

    T(*sx)[kC] = sm.x[st];
    T(*sla)[kC] = sm.la[st];
    const T(*sdy)[kC] = sm.dy[st];
    const float h_tile =
        d < D ? car[static_cast<long long>(i) * D + d] : 0.f;
    float hl[kK], ap[kK], gl[kK], gm[kK];
    float h = 0.f, A = 1.f;
#pragma unroll
    for (int k = 0; k < kK; ++k) {  // the run forward from h = 0
      const float lv = to_f(sla[w * kK + k][c]);
      const float a = expf(lv);
      const float gate = sqrt_approx(fmaxf(1.f - expf(2.f * lv), 0.f));
      h = a * h + gate * to_f(sx[w * kK + k][c]);
      A *= a;
      hl[k] = h;
      ap[k] = A;
    }
    float e = 0.f, P = 1.f;
#pragma unroll
    for (int k = kK - 1; k >= 0; --k) {  // and backward from e = 0
      const float a = expf(to_f(sla[w * kK + k][c]));
      gl[k] = to_f(sdy[w * kK + k][c]) + e;
      gm[k] = P;  // the product of a after step k in the run
      e = a * gl[k];
      P *= a;
    }
    sm.end_a[w][c] = A;
    sm.end_h[w][c] = h;
    sm.end_p[w][c] = P;
    sm.end_e[w][c] = e;
    __syncthreads();
    float h_in = h_tile, hc = h_tile;
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      if (j == w) h_in = hc;
      hc = fmaf(sm.end_a[j][c], hc, sm.end_h[j][c]);
    }
    float e_in = 0.f;  // e at the first step after this warp's run
#pragma unroll
    for (int j = kW - 1; j >= 0; --j) {
      if (j == w) e_in = e_tile;
      e_tile = fmaf(sm.end_p[j][c], e_tile, sm.end_e[j][c]);
    }
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const int t = w * kK + k;
      const float lv = to_f(sla[t][c]), xv = to_f(sx[t][c]);
      const float a = expf(lv);
      const float gate = sqrt_approx(fmaxf(1.f - expf(2.f * lv), 0.f));
      const float g = fmaf(gm[k], e_in, gl[k]);
      const float hp = k == 0 ? h_in : fmaf(ap[k - 1], h_in, hl[k - 1]);
      const float q = gate > 0.f ? a * a * xv / gate : 0.f;
      put(sx[t][c], gate * g);
      put(sla[t][c], g * (a * hp - q));
    }
    __syncthreads();
    store_tile<T, kVec16>(dx, sx, i * kT, d0, S, D);
    store_tile<T, kVec16>(dla, sla, i * kT, d0, S, D);
  }
}

template <typename T, bool kVec16>
cudaError_t launch_bwd(const void* x, const void* la, const void* dy,
                       const float* dh_final, void* dx, void* dla,
                       float* carries, int B, int S, int D, cudaStream_t s) {
  constexpr int kSmem = sizeof(SmemBwd<T>);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        rglru_bwd_kernel<T, kVec16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((D + kC - 1) / kC, B);
  rglru_bwd_kernel<T, kVec16><<<grid, kThreads, kSmem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(la),
      static_cast<const T*>(dy), dh_final, static_cast<T*>(dx),
      static_cast<T*>(dla), carries, S, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* rglru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16 (x, log_a and y alike); h_final float32.
// vec16: 1 if every row of x, log_a and y starts on 16 bytes (16-byte
// copies), 0 for one-element copies.
int rglru_scan_fwd(int dtype, int vec16, const void* x, const void* log_a,
                   void* y, float* h_final, int B, int S, int D,
                   void* stream) {
  if (B < 0 || S < 0 || D < 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || D == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = vec16 ? launch<float, true>(x, log_a, y, h_final, B, S, D, s)
                : launch<float, false>(x, log_a, y, h_final, B, S, D, s);
  else if (dtype == 1)
    err = vec16
              ? launch<__nv_bfloat16, true>(x, log_a, y, h_final, B, S, D, s)
              : launch<__nv_bfloat16, false>(x, log_a, y, h_final, B, S, D,
                                             s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// The backward: dx, dlog_a (the dtype of x, log_a and dy) from dy and
// dh_final (float32 (B, D), or null for zero); carries is float32 scratch
// of B * ceil(S / kT) * D (kT = 128 in bf16, 64 in float32).  vec16: 1 if
// every row of x, log_a, dy, dx and dlog_a starts on 16 bytes.
int rglru_scan_bwd(int dtype, int vec16, const void* x, const void* log_a,
                   const void* dy, const float* dh_final, void* dx,
                   void* dlog_a, float* carries, int B, int S, int D,
                   void* stream) {
  if (B < 0 || S < 0 || D < 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || D == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = vec16 ? launch_bwd<float, true>(x, log_a, dy, dh_final, dx, dlog_a,
                                          carries, B, S, D, s)
                : launch_bwd<float, false>(x, log_a, dy, dh_final, dx,
                                           dlog_a, carries, B, S, D, s);
  else if (dtype == 1)
    err = vec16 ? launch_bwd<__nv_bfloat16, true>(x, log_a, dy, dh_final, dx,
                                                  dlog_a, carries, B, S, D, s)
                : launch_bwd<__nv_bfloat16, false>(x, log_a, dy, dh_final,
                                                   dx, dlog_a, carries, B, S,
                                                   D, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
