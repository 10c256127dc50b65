// The grouped matmul's weight gradient, hand-written for Hopper (sm_90a).
//
// Part of the backward of the grouped matmul (csrc/moe_gmm.cu), which
// replaces the Pallas kernel gmm (_gmm_kernel) of
// src/repro/kernels/moe_gmm.py; the reference has no backward kernel and
// differentiates its expert einsums (src/repro/models/moe.py expert_ffn) by
// autodiff.  For x (T, Din), dy (T, Dout), block_expert (T / block_t,) and
// optional row counts block_rows (T / block_t,):
//
//   dw[e] = sum over blocks i with block_expert[i] == e, in index order, of
//           x[i*block_t : i*block_t + n_i]^T @ dy[i*block_t : ... + n_i]
//
// with n_i = block_rows[i] clamped to [0, block_t] (block_t when there are
// no counts), summed in float32 and written once in x's type; an expert
// that no block names, or whose blocks hold no counted row, is zero.  On
// the a2a path several blocks name one expert (one per dp shard).
//
// Bound: the gradient of every expert is written, Din x Dout each (10.7 GB
// a product at llama4-maverick's widths, 7.5 GB at deepseek-v3's), and the
// counted rows of x and dy are read; deepseek-v3's products at a training
// batch of 2 x 4,096 tokens (top-8, 320 rows an expert) are 1.92 TFLOP,
// within 1.4x of the card's ridge point, so bf16 runs on the tensor cores.
//
// Two kernels, chosen by the wrapper from dtype, widths and alignment:
//
// gmm_dw_wgmma_kernel (bfloat16, Din % 8 == 0, Dout % 8 == 0, 16-byte
// aligned x, dy and dw): wgmma fed by TMA.  A work item is a pair of 128 x
// 256 tiles of one expert's gradient, one above the other, which a cluster
// of two CTAs computes: both need the same dy columns at every step, so
// each CTA loads half of them into both by TMA multicast, and L2 serves
// the pair's dy once.  Persistent clusters, as many as the card holds at
// once, take every (gridDim.x / 2)-th item, and the items run in expert
// order, an expert's tiles adjacent, so the clusters in flight share one
// expert's x and dy rows in L2.  One producer warp lists its expert's
// blocks that hold a counted row, in index order, by ballots over 32
// block ids at a time, once when its expert changes (not once a tile;
// kListCap blocks at a time), and its lane 0 issues the TMA loads
// (cp.async.bulk.tensor, 128-byte swizzle) of each step, 64 token rows of
// x (the tile's 128 columns) and of dy (its 256), into a kStages = 3 deep
// mbarrier ring, with the step's counted rows and whether it ends the
// item beside it, in boxes of 64 columns; a block's last rows come in
// 16-row boxes, as far as its count reaches.  Two consumer warpgroups run
// wgmma.mma_async m64n256k16 with both operands MN-major (A = x^T, B =
// dy, transposed from shared memory), 64 gradient rows each, float32
// accumulators in registers, only the k16 steps that hold a counted row,
// and hand a stage back to both producers of the pair as soon as its
// products are done (a stage that only marks an expert with no counted
// row, once every thread of the warpgroup has read the mark).  TMA does
// not stop at a count: the rows past it in a block's last k16 step are
// zeroed in both operands before the product.  The epilogue rounds once to bf16 into a
// swizzled staging tile and stores it by TMA box by box (a 3-D map,
// clipped to the expert), each box waiting only for its own last store;
// the stores run while the next item's loads and products do.  The order
// of the sum is fixed (blocks in index order, rows in order, no atomics,
// no split over rows), so two calls are bitwise equal; an expert with no
// counted row writes zeros.
//
// gmm_dw_kernel (float32, which must stay exact to float32 rounding, so no
// TF32; and bf16 the 16-byte copies cannot take): one thread block a tile
// of 32 x 256 of one expert's gradient, 256 threads of 4 x 8 each.  It
// finds its expert's blocks itself: the threads read block_expert and
// block_rows in chunks of the block's size, and a ballot and a prefix over
// the warps list the chunk's blocks on the expert that hold a counted row,
// in index order, in shared memory (no host read, no sort).  It walks
// their counted rows in steps of kBK, the step's x slice staged as float
// and its dy slice in its own type, and never reads a row past a count, in
// the same fixed order.
//
// block_expert values are clamped to [0, E), as in the forward.  Each C
// entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

__device__ __forceinline__ int block_count(const int* block_rows,
                                           long long blk, int block_t) {
  return block_rows ? min(max(block_rows[blk], 0), block_t) : block_t;
}

// The blocks base .. base + kThreads - 1 on expert e that hold a counted
// row, in index order, into list (their index) and cnt (their count);
// returns how many.  Every thread of the block calls it; the block's
// earlier reads of list and cnt are over when it writes them.
template <int kThreads>
__device__ int find_blocks(const int* __restrict__ block_expert,
                           const int* __restrict__ block_rows, int nb,
                           int base, int e, int E, int block_t, int* list,
                           int* cnt, int* warp_tot) {
  __syncthreads();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = base + tid;
  int n = 0;
  if (i < nb && min(max(block_expert[i], 0), E - 1) == e)
    n = block_count(block_rows, i, block_t);
  const unsigned hits = __ballot_sync(0xffffffffu, n > 0);
  if (lane == 0) warp_tot[warp] = __popc(hits);
  __syncthreads();
  int off = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    const int t = warp_tot[w];
    off += w < warp ? t : 0;
    total += t;
  }
  if (n > 0) {
    const int j = off + __popc(hits & ((1u << lane) - 1u));
    list[j] = i;
    cnt[j] = n;
  }
  __syncthreads();
  return total;
}

// ---------------------------------------------------------------------------
// the CUDA-core kernel (float32, and bf16 the 16-byte copies cannot take)
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kTM = 4;             // gradient rows (of Din) per thread
constexpr int kTN = 8;             // gradient columns (of Dout) per thread
constexpr int kBM = 8 * kTM;       // tile rows: 8 row groups
constexpr int kBN = 32 * kTN;      // tile columns: 32 column groups
constexpr int kBK = 32;            // token rows per staged step

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// the eight values at p (16-byte aligned in shared memory) as float
__device__ __forceinline__ void load8(const float* p, float (&v)[kTN]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float (&v)[kTN]) {
  const uint4 u = reinterpret_cast<const uint4*>(p)[0];
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 -> float is a 16-bit shift
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// the eight values of v to p (16-byte aligned in device memory)
__device__ __forceinline__ void store8(float* p, const float (&v)[kTN]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(bf16* p, const float (&v)[kTN]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  reinterpret_cast<uint4*>(p)[0] = make_uint4(w[0], w[1], w[2], w[3]);
}

// rows 0 .. rows-1 of dy (from d, rows Dout apart), columns n0 .. n0+kBN-1
// into ds, zeros past the rows and the edge.  kVec: Dout is a multiple of
// the 16-byte vector and dy is 16-byte aligned.
template <typename T, bool kVec>
__device__ __forceinline__ void load_dy_tile(T (*ds)[kBN], const T* d,
                                             int rows, int n0, int Dout) {
  if constexpr (kVec) {
    constexpr int kV = 16 / sizeof(T);
    constexpr int kPerRow = kBN / kV;
    for (int v = threadIdx.x; v < kBK * kPerRow; v += kThreads) {
      const int r = v / kPerRow, c = (v % kPerRow) * kV;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r < rows && n0 + c < Dout)
        val = *reinterpret_cast<const uint4*>(
            d + static_cast<long long>(r) * Dout + n0 + c);
      *reinterpret_cast<uint4*>(&ds[r][c]) = val;
    }
  } else {
    for (int v = threadIdx.x; v < kBK * kBN; v += kThreads) {
      const int r = v / kBN, c = v % kBN;
      ds[r][c] = (r < rows && n0 + c < Dout)
                     ? d[static_cast<long long>(r) * Dout + n0 + c]
                     : T(0.f);
    }
  }
}

// grid = (ceil(Dout / kBN), ceil(Din / kBM), E)
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    gmm_dw_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                  const int* __restrict__ block_expert,
                  const int* __restrict__ block_rows, T* __restrict__ dw,
                  int E, int Din, int Dout, int block_t, int nb) {
  __shared__ float xs[kBK][kBM];
  __shared__ __align__(16) T ds[kBK][kBN];
  __shared__ int list[kThreads], cnt[kThreads], warp_tot[kThreads / 32];

  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int base = 0; base < nb; base += kThreads) {
    const int n_list = find_blocks<kThreads>(block_expert, block_rows, nb,
                                             base, e, E, block_t, list, cnt,
                                             warp_tot);
    for (int j = 0; j < n_list; ++j) {
      const long long row0 = static_cast<long long>(list[j]) * block_t;
      const int n = cnt[j];
      for (int r0 = 0; r0 < n; r0 += kBK) {
        const int rows = min(kBK, n - r0);
        const T* xb = x + (row0 + r0) * Din;
        for (int v = threadIdx.x; v < kBK * kBM; v += kThreads) {
          const int r = v / kBM, c = v % kBM;
          xs[r][c] = (r < rows && m0 + c < Din)
                         ? to_f(xb[static_cast<long long>(r) * Din + m0 + c])
                         : 0.f;
        }
        load_dy_tile<T, kVec>(ds, dy + (row0 + r0) * Dout, rows, n0, Dout);
        __syncthreads();
        for (int k = 0; k < rows; ++k) {
          float dv[kTN];
          load8(&ds[k][tx * kTN], dv);
#pragma unroll
          for (int i = 0; i < kTM; ++i) {
            const float xv = xs[k][ty * kTM + i];   // a warp-wide broadcast
#pragma unroll
            for (int jj = 0; jj < kTN; ++jj)
              acc[i][jj] = fmaf(xv, dv[jj], acc[i][jj]);
          }
        }
        __syncthreads();
      }
    }
  }

  const int col = n0 + tx * kTN;
  T* de = dw + static_cast<long long>(e) * Din * Dout;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + ty * kTM + i;
    if (m >= Din) break;
    T* o = de + static_cast<long long>(m) * Dout;
    if (kVec && col + kTN <= Dout) {
      store8(o + col, acc[i]);
    } else {
#pragma unroll
      for (int jj = 0; jj < kTN; ++jj)
        if (col + jj < Dout) from_f(o + col + jj, acc[i][jj]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* dy, const int* block_expert,
           const int* block_rows, void* dw, int T_rows, int E, int Din,
           int Dout, int block_t, cudaStream_t s) {
  const dim3 grid((Dout + kBN - 1) / kBN, (Din + kBM - 1) / kBM, E);
  const bool vec =
      Dout % (16 / static_cast<int>(sizeof(T))) == 0 &&
      reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(dw) % 16 == 0;
  const T* xt = static_cast<const T*>(x);
  const T* dt = static_cast<const T*>(dy);
  T* wt = static_cast<T*>(dw);
  if (vec)
    gmm_dw_kernel<T, true><<<grid, kThreads, 0, s>>>(
        xt, dt, block_expert, block_rows, wt, E, Din, Dout, block_t,
        T_rows / block_t);
  else
    gmm_dw_kernel<T, false><<<grid, kThreads, 0, s>>>(
        xt, dt, block_expert, block_rows, wt, E, Din, Dout, block_t,
        T_rows / block_t);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the tensor-core kernel (bfloat16): wgmma fed by TMA
// ---------------------------------------------------------------------------

constexpr int kTileM = 128;        // gradient rows (of Din) an item
constexpr int kTileN = 256;        // gradient columns (of Dout) an item
constexpr int kK = 64;             // token rows a ring stage
constexpr int kStages = 3;         // ring depth
constexpr int kListCap = 512;      // blocks of one expert listed at a time
constexpr int kScan = 8;           // block ids a lane reads at once
constexpr int kConsumers = 256;    // two consumer warpgroups
constexpr int kMmaThreads = kConsumers + 128;   // and the producer's
constexpr int kBox = 64 * kK * 2;  // a 64-column box of kK rows: 8 KB
constexpr int kTail = 64 * 16 * 2; // a 64-column box of 16 rows
constexpr int kXBytes = (kTileM / 64) * kBox;   // x: 2 boxes
constexpr int kHalf = kTileN / 128;             // dy boxes a CTA loads
constexpr int kStage = kXBytes + (kTileN / 64) * kBox;   // and dy: 4
constexpr int kOutBox = 64 * kTileM * 2;   // 64 gradient columns, 128 rows
constexpr int kOut = (kTileN / 64) * kOutBox;
constexpr int kMmaSmem = 1024 + kStages * kStage + kOut + 8 * kListCap +
                         8 * kStages + 16 * kStages;
static_assert(kMmaSmem <= 232448, "shared memory per block");

// the first of the 64-column dy boxes that CTA `rank` of a pair loads
__device__ __forceinline__ int n0_half(int rank) { return rank * kHalf; }

// a ring stage's step: its counted rows (0: the item's expert has none)
// and whether it is the item's last
struct Step {
  int rows;
  int last;
};

// Up to kListCap blocks from `from` on that are on expert e and hold a
// counted row, in index order, into list ({block, count}); the producer
// warp's lanes read 32 * kScan block ids and counts at once (independent
// loads, one round trip) and list them 32 at a time.  Returns how many,
// and where the next window starts (nb when every such block is listed).
struct Window {
  int n;
  int next;
};
__device__ Window list_blocks(int2* list, const int* __restrict__ block_expert,
                              const int* __restrict__ block_rows, int nb,
                              int from, int e, int E, int block_t,
                              int lane) {
  __syncwarp();                   // every lane is done with the last window
  int n = 0;
  for (int c0 = from; c0 < nb; c0 += 32 * kScan) {
    int cnt[kScan];
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      const int i = c0 + 32 * u + lane;
      const int ex = i < nb ? min(max(block_expert[i], 0), E - 1) : -1;
      const int rows = i < nb ? block_count(block_rows, i, block_t) : 0;
      cnt[u] = ex == e ? rows : 0;
    }
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      const int c = c0 + 32 * u;
      const unsigned hits = __ballot_sync(0xffffffffu, cnt[u] > 0);
      const int room = kListCap - n;
      const int rank = __popc(hits & ((1u << lane) - 1u));
      if (cnt[u] > 0 && rank < room)
        list[n + rank] = make_int2(c + lane, cnt[u]);
      if (__popc(hits) > room) {  // the window is full: the next hit is next
        unsigned rest = hits;
        for (int k = 0; k < room; ++k) rest &= rest - 1u;
        __syncwarp();
        return {kListCap, c + __ffs(rest) - 1};
      }
      n += __popc(hits);
    }
  }
  __syncwarp();
  return {n, nb};
}

// the k16 steps of one ring stage, A = x^T (this warpgroup's 64 rows of
// the tile) and B = dy (256 columns), both MN-major
template <int N16>
__device__ __forceinline__ void stage_mma(float (&acc)[128],
                                          const unsigned char* st, int wg) {
  const unsigned char* xa = st + wg * kBox;
  const unsigned char* db = st + kXBytes;
#pragma unroll
  for (int kk = 0; kk < N16; ++kk)
    wgmma_m64n256_mn(acc, desc_sw128(xa + kk * 2048, kBox, 1024),
                     desc_sw128(db + kk * 2048, kBox, 1024));
}

// items: (expert, pair of tile rows, tile_n), an expert's tiles adjacent,
// tile_n fastest; clusters of two CTAs, persistent, take every
// (gridDim.x / 2)-th item, CTA rank r the item's tile row 2 * pair + r, and
// the two share the dy columns of their step: each loads half of them into
// both by multicast
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kMmaThreads, 1)
    gmm_dw_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                        const __grid_constant__ CUtensorMap dy_map,
                        const __grid_constant__ CUtensorMap x16_map,
                        const __grid_constant__ CUtensorMap dy16_map,
                        const __grid_constant__ CUtensorMap dw_map,
                        const int* __restrict__ block_expert,
                        const int* __restrict__ block_rows, int E, int Din,
                        int Dout, int block_t, int nb, int pairs_m,
                        int tiles_n, int items) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  unsigned char* out = ring + kStages * kStage;
  int2* list = reinterpret_cast<int2*>(out + kOut);
  Step* meta = reinterpret_cast<Step*>(list + kListCap);
  uint64_t* full = reinterpret_cast<uint64_t*>(meta + kStages);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);     // each consumer warpgroup of the pair
    }
    fence_barrier_init();
  }
  cluster_sync();                  // the pair's barriers are ready
  const int tiles = pairs_m * tiles_n;
  const int rank = static_cast<int>(cluster_rank());
  const int first = blockIdx.x / 2, stride = gridDim.x / 2;

  if (threadIdx.x >= kConsumers) {
    // ------- producer: one warp lists the blocks, its lane 0 loads -------
    setmaxnreg_dec<56>();
    if (threadIdx.x >= kConsumers + 32) return;
    const int lane = threadIdx.x % 32;
    const int dh = n0_half(rank);      // this CTA's half of the dy columns
    int q = 0;
    int listed = -1;       // the expert whose blocks the list holds whole
    int n_list = 0;
    for (int it = first; it < items; it += stride) {
      const int e = it / tiles, tile = it % tiles;
      const int m0 = (2 * (tile / tiles_n) + rank) * kTileM;
      const int n0 = (tile % tiles_n) * kTileN;
      int next = listed == e ? nb : 0;   // nb: the list is whole already
      bool any = false;
      do {
        if (listed != e || next < nb) {
          const Window win = list_blocks(list, block_expert, block_rows, nb,
                                         next, e, E, block_t, lane);
          listed = next == 0 && win.next == nb ? e : -1;
          n_list = win.n;
          next = win.next;
        }
        for (int j = 0; j < n_list; ++j) {
          const int2 b = list[j];
          for (int r = 0; r < b.y; r += kK, ++q) {
            if (lane == 0) {
              const int s = q % kStages;
              const int rows = min(kK, b.y - r);
              mbar_wait(&empty[s], ((q / kStages) & 1) ^ 1);
              meta[s] = {rows, next == nb && j == n_list - 1 && r + kK >= b.y};
              unsigned char* st = ring + s * kStage;
              const int row = b.x * block_t + r;
              // x: this CTA's own; dy: its half into both CTAs (the
              // barrier expects both halves)
              unsigned char* dh_st = st + kXBytes + dh * kBox;
              if (rows == kK) {
                mbar_arrive_tx(&full[s], kStage);
                for (int i = 0; i < kTileM / 64; ++i)
                  tma_load_2d(st + i * kBox, &x_map, &full[s], m0 + 64 * i,
                              row);
                for (int i = 0; i < kHalf; ++i)
                  tma_load_2d_mc(dh_st + i * kBox, &dy_map, &full[s],
                                 n0 + 64 * (dh + i), row, 0x3);
              } else {     // a block's last rows: as many 16-row boxes
                const int n16 = (rows + 15) / 16;
                mbar_arrive_tx(&full[s], n16 * kTail * (kStage / kBox));
                for (int t = 0; t < n16; ++t) {
                  for (int i = 0; i < kTileM / 64; ++i)
                    tma_load_2d(st + i * kBox + t * kTail, &x16_map,
                                &full[s], m0 + 64 * i, row + 16 * t);
                  for (int i = 0; i < kHalf; ++i)
                    tma_load_2d_mc(dh_st + i * kBox + t * kTail, &dy16_map,
                                   &full[s], n0 + 64 * (dh + i),
                                   row + 16 * t, 0x3);
                }
              }
            }
            any = true;
          }
        }
      } while (next < nb);
      if (!any) {          // no counted row: a stage without data marks it
        if (lane == 0) {
          const int s = q % kStages;
          mbar_wait(&empty[s], ((q / kStages) & 1) ^ 1);
          meta[s] = {0, 1};
          mbar_arrive(&full[s]);
        }
        ++q;
      }
    }
    // the last loads have landed before the block exits
    if (lane == 0)
      for (int d = max(0, q - kStages); d < q; ++d)
        mbar_wait(&full[d % kStages], (d / kStages) & 1);
    cluster_sync();                // neither CTA exits while the other works
    return;
  }

  // ------------------ consumers: two warpgroups of wgmma -----------------
  setmaxnreg_inc<224>();
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const bool signal = tid == 0;
  int q = 0;
  // a stage goes back to both producers: the pair's dy halves land in both
  auto release = [&](int s) {
    mbar_arrive_cluster(&empty[s], 0);
    mbar_arrive_cluster(&empty[s], 1);
  };
  for (int it = first; it < items; it += stride) {
    const int e = it / tiles, tile = it % tiles;
    const int m0 = (2 * (tile / tiles_n) + rank) * kTileM;
    const int n0 = (tile % tiles_n) * kTileN;
    float acc[128];
#pragma unroll
    for (int j = 0; j < 128; ++j) acc[j] = 0.f;
    Step step;
    do {
      const int s = q % kStages;
      mbar_wait(&full[s], (q / kStages) & 1);
      ++q;
      step = meta[s];
      if (step.rows == 0) {          // the marker of an expert with no row
        // no wgmma orders the warpgroup's reads of meta[s] before the
        // release here: the producers could refill the stage under a
        // warp that has not read it yet
        named_barrier(2 + wg, 128);
        if (signal) release(s);
        continue;
      }
      unsigned char* st = ring + s * kStage;
      const int n16 = (step.rows + 15) / 16;
      if (step.rows % 16) {
        // rows past the count in the last k16 step hold other tokens or
        // arbitrary values: zeros in both operands (x and dy), so that
        // not even a NaN there reaches the sum
        const int zr = 16 * n16 - step.rows;
        for (int i = threadIdx.x; i < zr * 6 * 8; i += kConsumers) {
          const int r = step.rows + i / 48, b = (i % 48) / 8, c = i % 8;
          *reinterpret_cast<uint4*>(st + b * kBox + r * 128 + c * 16) =
              make_uint4(0, 0, 0, 0);
        }
        fence_proxy_async();
        named_barrier(1, kConsumers);
      }
      wgmma_fence();
      switch (n16) {
        case 1: stage_mma<1>(acc, st, wg); break;
        case 2: stage_mma<2>(acc, st, wg); break;
        case 3: stage_mma<3>(acc, st, wg); break;
        default: stage_mma<4>(acc, st, wg); break;
      }
      wgmma_commit();
      wgmma_wait<0>();
      if (signal) release(s);
    } while (!step.last);

    // epilogue, box by box: round once to bf16 into the staging tile (four
    // boxes of 64 columns x 128 rows in the 128-byte swizzle:
    // conflict-free, since a warp's 8 rows take 8 distinct chunks), then
    // one thread stores the box by TMA, clipped to the expert's (Din,
    // Dout); each box waits only for its own last store to have read it,
    // and the stores run while the next boxes are staged and the next
    // item's loads and products run
#pragma unroll
    for (int b = 0; b < kTileN / 64; ++b) {
      if (threadIdx.x == 0) bulk_wait_read_3();   // this box's last store
      named_barrier(1, kConsumers);
#pragma unroll
      for (int j = 8 * b; j < 8 * b + 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wg * 64 + warp * 16 + lane / 4 + 8 * h;
          unsigned char* p = out + b * kOutBox + r * 128 +
                             (((j % 8) ^ (r % 8)) * 16) + (lane % 4) * 4;
          *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(
              acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
      fence_proxy_async();
      named_barrier(1, kConsumers);
      if (threadIdx.x == 0) {      // a group a box, empty past Dout
        if (n0 + 64 * b < Dout)
          tma_store_3d(&dw_map, out + b * kOutBox, n0 + 64 * b, m0, e);
        bulk_commit();
      }
    }
  }
  if (threadIdx.x == 0) bulk_wait();
  cluster_sync();
}

}  // namespace

extern "C" {

const char* gmm_dw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The CUDA-core kernel.  dtype: 0 = float32, 1 = bfloat16 (x, dy and dw
// alike); block_expert int32 of T / block_t entries, block_rows the same or
// null (every row counts).  x (T, Din), dy (T, Dout), dw (E, Din, Dout),
// all contiguous.
int gmm_dw(int dtype, const void* x, const void* dy, const int* block_expert,
           const int* block_rows, void* dw, int T, int E, int Din, int Dout,
           int block_t, void* stream) {
  if (T < 0 || E < 1 || Din < 0 || Dout < 0 || block_t < 1 || T % block_t)
    return static_cast<int>(cudaErrorInvalidValue);
  if (E > 65535 || (Din + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Din == 0 || Dout == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dy, block_expert, block_rows, dw, T, E, Din,
                         Dout, block_t, s);
  if (dtype == 1)
    return launch<bf16>(x, dy, block_expert, block_rows, dw, T, E, Din, Dout,
                        block_t, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core kernel: bfloat16 x, dy and dw, Din % 8 == 0,
// Dout % 8 == 0, every pointer 16-byte aligned (the wrapper checks).  As
// many clusters of two as the card holds at once (at most one an item)
// walk the (expert, pair of 128 x 256 tiles) items.
int gmm_dw_mma(const void* x, const void* dy, const int* block_expert,
               const int* block_rows, void* dw, int T, int E, int Din,
               int Dout, int block_t, void* stream) {
  if (T < 0 || E < 1 || Din < 0 || Dout < 0 || block_t < 1 ||
      T % block_t || Din % 8 || Dout % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(dy) % 16 ||
      reinterpret_cast<uintptr_t>(dw) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Din == 0 || Dout == 0) return 0;
  if (T == 0)             // no rows: every gradient is zero, one memset
    return static_cast<int>(cudaMemsetAsync(
        dw, 0, sizeof(bf16) * static_cast<size_t>(E) * Din * Dout, s));
  static int max_pairs = 0;       // clusters of two the card holds at once
  if (max_pairs == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        gmm_dw_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMmaSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(2);
    cfg.blockDim = dim3(kMmaThreads);
    cfg.dynamicSmemBytes = kMmaSmem;
    err = cudaOccupancyMaxActiveClusters(&max_pairs, gmm_dw_wgmma_kernel,
                                         &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (max_pairs < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int tiles_m = (Din + kTileM - 1) / kTileM;
  const int pairs_m = (tiles_m + 1) / 2;
  const int tiles_n = (Dout + kTileN - 1) / kTileN;
  const long long items = static_cast<long long>(E) * pairs_m * tiles_n;
  if (items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int pairs = min(static_cast<int>(items), max_pairs);
  CUtensorMap x_map, dy_map, x16_map, dy16_map, dw_map;
  const uint64_t x_dims[2] = {static_cast<uint64_t>(Din),
                              static_cast<uint64_t>(T)};
  const uint64_t dy_dims[2] = {static_cast<uint64_t>(Dout),
                               static_cast<uint64_t>(T)};
  const uint64_t dw_dims[3] = {static_cast<uint64_t>(Dout),
                               static_cast<uint64_t>(Din),
                               static_cast<uint64_t>(E)};
  const uint32_t in_box[2] = {64, kK}, tail_box[2] = {64, 16};
  const uint32_t out_box[3] = {64, kTileM, 1};
  if (!bf16_map(&x_map, x, 2, x_dims, in_box) ||
      !bf16_map(&dy_map, dy, 2, dy_dims, in_box) ||
      !bf16_map(&x16_map, x, 2, x_dims, tail_box) ||
      !bf16_map(&dy16_map, dy, 2, dy_dims, tail_box) ||
      !bf16_map(&dw_map, dw, 3, dw_dims, out_box))
    return static_cast<int>(cudaErrorInvalidValue);
  gmm_dw_wgmma_kernel<<<2 * pairs, kMmaThreads, kMmaSmem, s>>>(
      x_map, dy_map, x16_map, dy16_map, dw_map, block_expert, block_rows,
      E, Din, Dout, block_t, T / block_t, pairs_m, tiles_n,
      static_cast<int>(items));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
