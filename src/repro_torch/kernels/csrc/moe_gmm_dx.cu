// The grouped matmul's input gradient on Hopper's tensor cores (sm_90a):
// wgmma fed by TMA.
//
// Part of the backward of the grouped matmul (csrc/moe_gmm.cu), which
// replaces the Pallas kernel gmm (_gmm_kernel) of
// src/repro/kernels/moe_gmm.py; the reference has no backward kernel and
// differentiates its expert einsums (src/repro/models/moe.py expert_ffn) by
// autodiff.  For dy (T, Dout), w (E, Din, Dout) as the forward takes it,
// block_expert (T / block_t,) and optional row counts block_rows:
//
//   dx[i*block_t + r] = dy[i*block_t + r] @ w[block_expert[i]]^T   r < n_i
//   dx[i*block_t + r] = 0                                           otherwise
//
// with n_i = block_rows[i] clamped to [0, block_t] (block_t without
// counts), summed in float32 and rounded once to bf16.  bf16 only, widths
// multiples of 8 and every base on 16 bytes (the wrapper's "mma" route);
// float32 and the rest take the CUDA-core instance of csrc/moe_gmm.cu.
//
// The layout needs no transpose: per block the product is "TN", A the
// block's dy rows (M x K, K = Dout contiguous) and B the expert's w as
// stored, (N x K) with K contiguous, which is wgmma's K-major B.  Nothing
// is copied.
//
// Bound: at llama4-maverick's widths (C 80, top-1) the live experts'
// weights, 10.7 GB a product, read once (3.2 ms at 3.35 TB/s); at
// deepseek-v3's (C 320, top-8) 1.92 TFLOP against 7.5 GB, near the card's
// ridge point.  The forward's kernel, on which this gradient ran before,
// streamed an expert's weights once per 64-row chunk of a block: twice for
// 80 rows, five times for 320, and the re-reads did not stay in L2.
//
// Design: each expert's weights come from device memory once a call,
// whatever the block's row count.  A work item is one pass of a block's
// rows (up to kPass = 320, five m64 tiles) times one tile of output
// columns, and one CTA holds the whole pass's accumulators for its tile,
// so every (block, tile) reads its slice of w once.  (A cluster of CTAs
// sharing the weight tile by TMA multicast would hold the same bytes
// with smaller CTAs; one CTA needs no cluster launch, and the
// accumulators fit: 320 x 128 float32 over 256 threads.)  Two instances:
// a pass of at most 128 rows (llama4) takes 2 m64 tiles and 256 columns,
// up to 320 rows (deepseek) 5 m64 tiles and 128 columns.  Consumer
// warpgroup w takes the m64 tiles w, w + 2, ... and multiplies each by
// the whole width (m64n256k16 or m64n128k16): a wide B per instruction
// keeps wgmma's shared-memory reads (A and B for every instruction) under
// the tensor cores' rate, which m64n64 per warpgroup did not.  One
// producer thread issues TMA loads (cp.async.bulk.tensor, 128-byte
// swizzle) of the weight tile and the dy rows into an mbarrier ring, k
// steps of 64 along Dout; the live tiles' last one only as far as 16-row
// boxes reach its count, and tiles wholly past the count are neither
// loaded nor multiplied.  A stage goes back to the producer as soon as
// its products are done, so all stages but one are loading.  CTAs are
// persistent, one an SM (at most one an item), and walk the items in
// order, a block's column tiles adjacent (its dy rows stay in
// L2).  Epilogue: each m64 tile is rounded to bf16 into a swizzled staging
// tile, rows past the count as zeros, and stored by TMA (a 3-D map over
// (nb, block_t, Din), so a tile's rows past the block are clipped); the
// store runs under the next tile's staging and the next item's steps.
// The 256-column instance stages in a tile of its own and keeps 3 ring
// stages; the 128-column one stages in the item's last ring stage,
// released once the stores have read it, and keeps 4.  The pass's rows
// past its live tiles are written as zeros by 16-byte stores, and a block
// whose count is 0 writes its zeros without reading w.  Rows that TMA
// loads past a count (the next block's, stale shared memory past a
// 16-row box) only reach output rows past the count, which go out as
// zeros; depth past Dout is zero-filled by TMA, and weight rows past Din
// (the next expert's) only reach columns past Din, which are not stored.
// A block_t above kPass runs in passes of kPass rows, each reading w once
// (no path has one today: C <= 320 at both published shapes); kPass is a
// multiple of 64, so a pass's m64 tiles, and their 64-row stores, end
// where the next pass begins.
//
// block_expert values are clamped to [0, E).  The C entry encodes the
// tensor maps (dy over (T, Dout) in boxes of 64 and of 16 rows, w over
// (E*Din, Dout), dx by block), launches on the caller's stream, allocates
// nothing and returns cudaGetLastError().

#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kBK = 64;             // depth (Dout) a ring stage: 128 bytes
constexpr int kPass = 320;          // rows a pass holds: five m64 tiles
constexpr int kWide = 128;          // a pass up to this: the 256-column one
constexpr int kConsumers = 256;     // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;   // and the producer's
constexpr int kTileA = 64 * kBK * 2;         // one m64 box of dy rows
constexpr int kTail = 16 * kBK * 2;          // a 16-row box of them
constexpr int kOutBox = 64 * 64 * 2;         // 64 rows of 64 dx columns

// kMT m64 tiles a pass at most, kBN output columns an item; warpgroup w
// takes the tiles w, w + 2, ..., at most kMW of them, and stages one of
// them at a time for its store in a tile of its own (kOut bytes each) or,
// kOut = 0, in its half of the item's last ring stage, released after
// the store has read it (the 128-column instance, which so keeps 4 stages)
template <int kMT, int kBN>
struct Cfg {
  static constexpr int kMW = (kMT + 1) / 2;
  static constexpr int kABytes = kMT * kTileA;
  static constexpr int kBBytes = kBN * kBK * 2;   // one box of w rows
  static constexpr int kStage = kABytes + kBBytes;
  static constexpr bool kInRing = kBN / 64 * kOutBox <= kStage / 2;
  static constexpr int kStages = kInRing ? 4 : 3;
  static constexpr int kOut = kInRing ? 0 : (kBN / 64) * kOutBox;
  static constexpr int kSmem =
      1024 + kStages * kStage + 2 * kOut + 2 * kStages * 8;
  static_assert(kSmem <= 232448, "shared memory per block");
};
static_assert(kPass % 64 == 0, "a pass ends on an m64 tile");

__device__ __forceinline__ int block_count(const int* block_rows, int blk,
                                           int block_t) {
  return block_rows ? min(max(block_rows[blk], 0), block_t) : block_t;
}

// one work item: one pass of a block's rows, output columns n0 .. n0+bn-1
struct Item {
  int blk;          // the block
  int p0;           // the pass's first row in it
  int row0;         // and in dy and dx
  int span;         // its rows (counted or not)
  int rows;         // its counted rows
  int n_mt;         // the m64 tiles that hold them
  int n0;           // first output column
  int w_row;        // the weight tile's first row in the (E*Din, Dout) map
};

__device__ __forceinline__ Item item_at(int it, int tiles, int passes,
                                        int pass_rows, int bn,
                                        const int* block_expert,
                                        const int* block_rows, int E,
                                        int Din, int block_t) {
  const int bp = it / tiles;
  Item t;
  t.blk = bp / passes;
  t.p0 = (bp % passes) * pass_rows;
  t.row0 = t.blk * block_t + t.p0;
  t.span = min(pass_rows, block_t - t.p0);
  t.rows = min(max(block_count(block_rows, t.blk, block_t) - t.p0, 0),
               t.span);
  t.n_mt = (t.rows + 63) / 64;
  t.n0 = (it % tiles) * bn;
  const int e = min(max(block_expert[t.blk], 0), E - 1);
  t.w_row = e * Din + t.n0;
  return t;
}

template <int kBN>
__device__ __forceinline__ void mma(float (&d)[kBN / 2], uint64_t da,
                                    uint64_t db) {
  if constexpr (kBN == 128)
    wgmma_m64n128_kk(d, da, db);
  else
    wgmma_m64n256_kk(d, da, db);
}

// the item's k steps, this warpgroup's L live m64 tiles (wg, wg + 2, ...)
// on the whole width: wait for a stage, issue its wgmmas, and release the
// stage before once that group is done (L = 0: wait and release only).
// Returns the last stage, released too unless the epilogue stages in it.
template <int L, int kMT, int kBN>
__device__ __forceinline__ int steps(float (&acc)[Cfg<kMT, kBN>::kMW]
                                                 [kBN / 2],
                                     unsigned char* ring, uint64_t* full,
                                     uint64_t* empty, int n_k, int& q,
                                     int wg, bool signal) {
  using C = Cfg<kMT, kBN>;
  constexpr int kStages = C::kStages;
  int last = 0;
  for (int k = 0; k < n_k; ++k, ++q) {
    const int s = q % kStages;
    mbar_wait(&full[s], (q / kStages) & 1);
    const unsigned char* a = ring + s * C::kStage;
    const unsigned char* b = a + C::kABytes;
    if constexpr (L > 0) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t db = desc_sw128(b + kk * 32, 16, 1024);
#pragma unroll
        for (int i = 0; i < L; ++i)
          mma<kBN>(acc[i],
                   desc_sw128(a + (wg + 2 * i) * kTileA + kk * 32, 16, 1024),
                   db);
      }
      wgmma_commit();
      wgmma_wait<0>();
    }
    if (signal && (k + 1 < n_k || !C::kInRing)) mbar_arrive(&empty[s]);
    last = s;
  }
  return last;
}

template <int kMT, int kBN>
__global__ void __launch_bounds__(kThreads, 1)
    gmm_dx_wgmma_kernel(const __grid_constant__ CUtensorMap dy_map,
                        const __grid_constant__ CUtensorMap dy16_map,
                        const __grid_constant__ CUtensorMap w_map,
                        const __grid_constant__ CUtensorMap dx_map,
                        const int* __restrict__ block_expert,
                        const int* __restrict__ block_rows,
                        bf16* __restrict__ dx, int E, int Din, int Dout,
                        int block_t, int pass_rows, int passes, int tiles,
                        int items) {
  using C = Cfg<kMT, kBN>;
  constexpr int kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  unsigned char* out = ring + kStages * C::kStage;   // a C::kOut a group
  uint64_t* full = reinterpret_cast<uint64_t*>(out + 2 * C::kOut);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);     // one arrival a consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int n_k = (Dout + kBK - 1) / kBK;

  if (threadIdx.x >= kConsumers) {
    // ---------------- producer: one thread issues every load -------------
    setmaxnreg_dec<40>();
    if (threadIdx.x != kConsumers) return;
    int q = 0;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const Item t = item_at(it, tiles, passes, pass_rows, kBN, block_expert,
                             block_rows, E, Din, block_t);
      if (t.rows == 0) continue;           // zeros only: w is not read
      // the last live m64 tile in 16-row boxes, as far as it is counted
      const int tail = (t.rows - 64 * (t.n_mt - 1) + 15) / 16;
      const int bytes = (t.n_mt - 1) * kTileA + tail * kTail + C::kBBytes;
      for (int k = 0; k < n_k; ++k, ++q) {
        const int s = q % kStages;
        mbar_wait(&empty[s], ((q / kStages) & 1) ^ 1);
        unsigned char* a = ring + s * C::kStage;
        mbar_arrive_tx(&full[s], bytes);
        tma_load_2d(a + C::kABytes, &w_map, &full[s], k * kBK, t.w_row);
        for (int m = 0; m + 1 < t.n_mt; ++m)
          tma_load_2d(a + m * kTileA, &dy_map, &full[s], k * kBK,
                      t.row0 + m * 64);
        for (int r = 0; r < tail; ++r)
          tma_load_2d(a + (t.n_mt - 1) * kTileA + r * kTail, &dy16_map,
                      &full[s], k * kBK, t.row0 + (t.n_mt - 1) * 64 + 16 * r);
      }
    }
    // the last loads have landed before the block exits
    for (int d = max(0, q - kStages); d < q; ++d)
      mbar_wait(&full[d % kStages], (d / kStages) & 1);
    return;
  }

  // ------------------ consumers: two warpgroups of wgmma -----------------
  setmaxnreg_inc<232>();
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const bool signal = tid == 0;
  int q = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const Item t = item_at(it, tiles, passes, pass_rows, kBN, block_expert,
                           block_rows, E, Din, block_t);
    // the pass's rows past its live m64 tiles: zeros (the live tiles'
    // rows past the count go out as zeros with their tile)
    const int z0 = min(64 * t.n_mt, t.span);
    for (int i = threadIdx.x; i < (t.span - z0) * (kBN / 8);
         i += kConsumers) {
      const int r = z0 + i / (kBN / 8), c = t.n0 + (i % (kBN / 8)) * 8;
      if (c < Din)
        *reinterpret_cast<uint4*>(
            dx + static_cast<long long>(t.row0 + r) * Din + c) =
            make_uint4(0, 0, 0, 0);
    }
    if (t.rows == 0) continue;
    float acc[C::kMW][kBN / 2];
#pragma unroll
    for (int i = 0; i < C::kMW; ++i)
#pragma unroll
      for (int j = 0; j < kBN / 2; ++j) acc[i][j] = 0.f;
    const int mine = (t.n_mt - wg + 1) / 2;   // this warpgroup's live tiles
    int last = 0;
    switch (mine) {
      case 0:
        last = steps<0, kMT, kBN>(acc, ring, full, empty, n_k, q, wg, signal);
        break;
      case 1:
        last = steps<1, kMT, kBN>(acc, ring, full, empty, n_k, q, wg, signal);
        break;
      case 2:
        if constexpr (C::kMW >= 2)
          last = steps<2, kMT, kBN>(acc, ring, full, empty, n_k, q, wg,
                                    signal);
        break;
      default:
        if constexpr (C::kMW >= 3)
          last = steps<3, kMT, kBN>(acc, ring, full, empty, n_k, q, wg,
                                    signal);
        break;
    }
    // epilogue, tile by tile: round once to bf16 into this warpgroup's
    // staging tile (boxes of 64 rows x 64 columns in the 128-byte swizzle:
    // a warp's 8 rows take 8 distinct chunks, no bank conflict), rows
    // past the count as zeros, then one thread stores it by TMA, clipped
    // to the block (a 3-D map over (nb, block_t, Din)); the store runs
    // while the next tile is staged and the next item's steps run
    unsigned char* stage = out + wg * C::kOut;
    if constexpr (C::kInRing) {
      stage = ring + last * C::kStage + wg * (C::kStage / 2);
      named_barrier(1, kConsumers);   // both groups' products read it
    }
#pragma unroll
    for (int i = 0; i < C::kMW; ++i) {
      if (i >= mine) break;
      const int m = wg + 2 * i;
      if (signal) bulk_wait_read();   // the group's last store has read it
      named_barrier(2 + wg, 128);
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = warp * 16 + lane / 4 + 8 * h;
          const bool live = m * 64 + r < t.rows;
          *reinterpret_cast<__nv_bfloat162*>(
              stage + (j / 8) * kOutBox + r * 128 +
              (((j % 8) ^ (r % 8)) * 16) + (lane % 4) * 4) =
              __floats2bfloat162_rn(live ? acc[i][4 * j + 2 * h] : 0.f,
                                    live ? acc[i][4 * j + 2 * h + 1] : 0.f);
        }
      }
      fence_proxy_async();
      named_barrier(2 + wg, 128);
      if (signal) {
        for (int b = 0; b < kBN / 64; ++b)
          if (t.n0 + 64 * b < Din)
            tma_store_3d(&dx_map, stage + b * kOutBox, t.n0 + 64 * b,
                         t.p0 + 64 * m, t.blk);
        bulk_commit();
      }
    }
    if constexpr (C::kInRing) {      // the stage goes back to the producer
      if (signal) {
        bulk_wait_read();
        mbar_arrive(&empty[last]);
      }
    }
  }
  if (signal) bulk_wait();
}

template <int kMT, int kBN>
int launch(const CUtensorMap* maps, const int* block_expert,
           const int* block_rows, void* dx, int E, int Din, int Dout,
           int block_t, int pass_rows, int passes, int tiles, int items,
           cudaStream_t s) {
  using C = Cfg<kMT, kBN>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        gmm_dx_wgmma_kernel<kMT, kBN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  int dev = 0, n_sm = 0;     // one CTA an SM, at most one an item
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ctas = min(items, n_sm);
  gmm_dx_wgmma_kernel<kMT, kBN><<<ctas, kThreads, C::kSmem, s>>>(
      maps[0], maps[1], maps[2], maps[3], block_expert, block_rows,
      static_cast<bf16*>(dx), E, Din, Dout, block_t, pass_rows, passes,
      tiles, items);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* gmm_dx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dx (T, Din) = block i of dy (T, Dout) times w[block_expert[i]]^T, w (E,
// Din, Dout) as the forward takes it, rows past block_rows zero: bfloat16,
// Din % 8 == 0, Dout % 8 == 0, every pointer 16-byte aligned.  A pass
// holds min(block_t, kPass) rows: up to kWide take the 256-column
// instance, more the 128-column one.
int gmm_dx_mma(const void* dy, const void* w, const int* block_expert,
               const int* block_rows, void* dx, int T, int E, int Din,
               int Dout, int block_t, void* stream) {
  if (T < 0 || E < 1 || Din < 0 || Dout < 0 || block_t < 1 ||
      T % block_t || Din % 8 || Dout % 8 ||
      static_cast<long long>(E) * Din > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int pass_rows = min(block_t, kPass);
  const bool wide = pass_rows <= kWide;
  const int bn = wide ? 256 : 128;
  const int passes = (block_t + pass_rows - 1) / pass_rows;
  const int tiles = (Din + bn - 1) / bn;
  const long long items =
      static_cast<long long>(T / block_t) * passes * tiles;
  if (items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(dy) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(dx) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T == 0 || Din == 0) return 0;
  if (Dout == 0)          // no depth: dx is zero, one memset
    return static_cast<int>(cudaMemsetAsync(
        dx, 0, sizeof(bf16) * static_cast<size_t>(T) * Din, s));
  CUtensorMap maps[4];    // dy in 64- and 16-row boxes, w, dx by block
  const uint64_t dy_dims[2] = {static_cast<uint64_t>(Dout),
                               static_cast<uint64_t>(T)};
  const uint64_t w_dims[2] = {static_cast<uint64_t>(Dout),
                              static_cast<uint64_t>(E) * Din};
  const uint64_t dx_dims[3] = {static_cast<uint64_t>(Din),
                               static_cast<uint64_t>(block_t),
                               static_cast<uint64_t>(T / block_t)};
  const uint32_t dy_box[2] = {kBK, 64}, dy16_box[2] = {kBK, 16};
  const uint32_t w_box[2] = {kBK, static_cast<uint32_t>(bn)};
  const uint32_t dx_box[3] = {64, 64, 1};
  if (!bf16_map(&maps[0], dy, 2, dy_dims, dy_box) ||
      !bf16_map(&maps[1], dy, 2, dy_dims, dy16_box) ||
      !bf16_map(&maps[2], w, 2, w_dims, w_box) ||
      !bf16_map(&maps[3], dx, 3, dx_dims, dx_box))
    return static_cast<int>(cudaErrorInvalidValue);
  if (wide)
    return launch<2, 256>(maps, block_expert, block_rows, dx, E, Din, Dout,
                          block_t, pass_rows, passes, tiles,
                          static_cast<int>(items), s);
  return launch<5, 128>(maps, block_expert, block_rows, dx, E, Din, Dout,
                        block_t, pass_rows, passes, tiles,
                        static_cast<int>(items), s);
}

}  // extern "C"
