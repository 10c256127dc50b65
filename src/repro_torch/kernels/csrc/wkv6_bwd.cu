// RWKV-6 (Finch) WKV backward, hand-written for Hopper (sm_90a), in
// chunk-parallel form.
//
// No TPU kernel: the reference trains through jax.vjp of its training form,
// wkv6_chunked (src/repro/models/rwkv6.py:233), which runs kref.wkv6
// (src/repro/kernels/ref.py) in float32 over checkpointed chunks; this is
// that vjp.  The forward, per (b, h) with a D x D float32 state from zero:
//
//   y_t = r_t^T S_{t-1} + (sum_i r_t[i] u[i] k_t[i]) v_t
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// Given dy (the gradient of y) and ds_final (of S_final, or null for
// zero), with G_t the gradient of S_t (G_{S-1} = ds_final) and
// vdy_t = v_t . dy_t:
//
//   dr_t[i]  = sum_j S_{t-1}[i][j] dy_t[j] + u[i] k_t[i] vdy_t
//   dk_t[i]  = sum_j G_t[i][j] v_t[j]      + r_t[i] u[i] vdy_t
//   dw_t[i]  = sum_j S_{t-1}[i][j] G_t[i][j]
//   dv_t[j]  = sum_i G_t[i][j] k_t[i]      + (sum_i r_t[i] u[i] k_t[i]) dy_t[j]
//   du[i]    = sum_{b, t} r_t[i] k_t[i] vdy_t
//   G_{t-1}  = diag(w_t) G_t + r_t dy_t^T
//
// All float32, the training form's dtypes, every product on the CUDA cores.
// r, k, v, w and dy are read through element strides (b, h, t) with a
// contiguous D axis; dr, dk, dv and dw are written through one set of
// strides (the wrapper gives (B, S, H, D) memory), du (H, D) contiguous.
//
// Both recurrences are linear, so each jumps a span of steps in one
// product.  Over steps t0 .. t1 - 1, with P'_t = prod_{t0 <= tau < t} w_tau,
// Q_t = prod_{t < tau < t1} w_tau and W = prod_{t0 <= tau < t1} w_tau:
//
//   S_{t1-1}  = diag(W) S_{t0-1} + sum_t (k_t . Q_t) v_t^T
//   G_{t0-1}  = diag(W) G_{t1-1} + sum_t (r_t . P'_t) dy_t^T
//
// Every factor is a product of decays (at most 1): w = 0 gives exact
// zeros, and nothing is divided.  Time is cut into chunks of kL = 64 steps
// (the last padded with r = k = v = dy = 0 and w = 1, which leaves S and G
// as they are), and three kernels run on the caller's stream:
//
// wkv6_bwd_states_kernel (stage 1): one block per (b, h) for S and one for
//   G: 2 x B x H blocks of DP^2 / 32 threads, each holding an 8 x 4 tile of
//   the state in registers.  The S blocks walk the chunks forward and the
//   G blocks back, in jumps of kJ = 16 steps through a four-stage
//   cp.async ring: a thread a row scans its decays into the jump's prefix
//   (G) or suffix (S) products and scales r or k by them in place, then
//   the block takes the jump's product.  Before each chunk they write S^c
//   (the state before chunk c) and E^{c+1} (the gradient of the state
//   after it; ds_final for the last) into one float32 scratch of B x H x
//   n_chunks x 2 x DP x DP floats: 268 MB at rwkv6-7b's training shape (B
//   2, H 64, S 4,096, D 64).  Each input is read once.  Rows and columns
//   past D (D = 48 runs the DP = 64 instance) are zeros and stay zeros.
// wkv6_bwd_chunks_kernel (stage 2): every chunk's gradients, each on its
//   own.  As many blocks as fit on the card (one an SM at DP = 64) take
//   chunk after chunk; a block of DP x DP / 8 threads, each holding two
//   rows by four columns of S and of G (DP / 4 threads a row pair).  The
//   chunk's r, k, w, v and dy come into shared memory by cp.async (16-byte
//   copies where every row starts on 16 bytes, else 4-byte ones) in four
//   groups of 16 steps; the next chunk's groups are issued while this
//   chunk's last groups compute, into the part of shared memory its kept
//   states have freed (two layouts, alternating), by the half of the
//   block that is not summing dv at that moment.  The forward walk from
//   S^c is taken by a quarter of the threads, 4 x 4 tiles (fewer shared
//   loads a step), which keep S every 8 steps in shared memory for the
//   threads that own those rows; meanwhile the other warps take vdy_t and
//   bonus_t of every step.  The backward walk takes G back from E^{c+1},
//   4 steps at a time: the 4 states S_{t-1} it needs are recomputed into
//   registers from the nearest kept state, and each step gives dr, dk, dw
//   and dv.  Row sums (dr, dk, dw) reduce over the row pair's DP / 4
//   lanes, 4 steps and both rows at once (each exchange hands the partner
//   the half it keeps); dv's column sums add the thread's two rows, then
//   reduce over the warp's row pairs the same way, then over the warps
//   through a double-buffered shared array, in order.  du's terms add up
//   per row into one partial per (b, chunk, h).
// wkv6_bwd_du_kernel: du[h][i] = the partials summed over b and chunk in a
//   fixed order: no atomics, so two calls are bitwise equal.
//
// Bound: at the training shape, r, k, v, w, dy and the four gradients are
// 9 x 134 MB (0.361 ms at 3.35 TB/s); the work is ~12 D^2 float32
// operations a step and head (the updates of S and G and the four
// products dr, dk, dv, dw: 25.8 GFLOP, 0.385 ms at 67 TFLOP/s).  This
// design's own floor: both stages read the inputs (stage 1 reads k, w, v
// for S and r, w, dy for G: six arrays; stage 2 the five), the scratch is
// written once and read once, the gradients written once: ~2.55 GB,
// ~0.76 ms; its arithmetic is ~10.5 D^2 operations a step in stage 2 (S
// walked forward, then again in the recompute) and 2 D^2 in stage 1.
//
// What this design does about the earlier three-kernel form (a rows kernel
// walking all S steps twice per block and a dv kernel walking them again):
// 8,192 independent chunks at the training shape instead of 512 blocks
// (the longest dependent chain is S / 16 jumps plus 64 steps, not 8,192
// steps); the loads are in flight while the chunks compute, the next
// chunk's behind this one's; v and dy are staged once a chunk, not once
// per row block; S is checkpointed every 64 steps (268 MB, not 537) and
// built by products in stage 1, which reads each input once; dv is folded
// into stage 2, so no kernel walks every step of a sequence; and a thread
// holds 8 elements and 4 recomputed states, not 16 states of 4 (no spills
// at D = 64).  Shared-memory loads, more than arithmetic, bound the walks
// (a 16-byte load costs four of the memory's cycles for a warp, whatever
// the addresses), hence the tiles of two rows by four columns and the
// forward's 4 x 4 ones, each load serving more products.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kL = 64;        // steps a chunk: the spacing of the states
constexpr int kJ = 16;        // steps a jump of stage 1
constexpr int kStages = 4;    // stage 1's ring of jumps
constexpr int kSub = 8;       // steps between the states stage 2 keeps
constexpr int kHist = 4;      // states S_{t-1} a stage-2 thread recomputes
constexpr int kGroups = kL / kSub;

enum { kR, kK, kW, kV, kDY };          // the inputs, in Args::in
enum { kDR, kDK, kDV, kDW };           // the gradients, in Args::out

struct Args {
  const float* in[5];                  // r, k, w, v, dy
  long long sb[5], sh[5], ss[5];       // their element strides
  const float* u;                      // (H, D)
  const float* ds;                     // (B, H, D, D) or null
  float* out[4];                       // dr, dk, dv, dw
  long long o_sb, o_sh, o_ss;
  float* du;                           // (H, D)
  float* states;                       // (B, H, n_chunks, 2, DP, DP)
  float* du_part;                      // (B, n_chunks, H, DP)
  int B, H, S, D, n_chunks;
};

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
// 4 bytes global -> shared, a zero where valid == false
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}
// wait until at most `pending` (0 .. 3) groups are in flight
__device__ __forceinline__ void cp_async_wait_groups(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// Copies element (or 16-byte group) c of step t of an input, from its
// (b, h) row `base` with time stride ss, to dst: zeros past S or past D,
// except w (`is_w`) past S, which is 1.
template <bool kVec16>
__device__ __forceinline__ void copy_in(float* dst, const float* base,
                                        long long ss, bool is_w, int t, int c,
                                        const Args& a) {
  if (is_w && t >= a.S) {
    if constexpr (kVec16)
      *reinterpret_cast<float4*>(dst) = make_float4(1.f, 1.f, 1.f, 1.f);
    else
      *dst = 1.f;
    return;
  }
  const bool ok = t < a.S && c < a.D;
  const float* src = ok ? base + t * ss + c : base;
  if constexpr (kVec16)
    cp_async16(dst, src, ok);
  else
    cp_async4(dst, src, ok);
}

// Input `arr`'s row of (b, h).
__device__ __forceinline__ const float* input(const Args& a, int arr, int b,
                                              int h) {
  return a.in[arr] + b * a.sb[arr] + h * a.sh[arr];
}

// Reduce-scatter of x[0 .. N) over the lanes that differ in bits kHi,
// kHi / 2, ..., kLo of the lane index: while more than one value is left,
// each exchange hands the partner lane the half it keeps (the upper half
// on the lane whose bit is set); then the rest add the one value whole.
// The lane is left with the sums of values base .. base + (its count) - 1
// in x[0 ..]; `owner` stays true on one lane of each group holding the
// same sums.
template <int N, int kHi, int kLo, int kN>
__device__ __forceinline__ void scatter(float (&x)[kN], int lane, int& base,
                                        bool& owner) {
  if constexpr (kHi >= kLo && kHi > 0) {
    if constexpr (N > 1) {
      constexpr int kHalf = N / 2;
      const bool upper = lane & kHi;
#pragma unroll
      for (int q = 0; q < kHalf; ++q) {
        const float send = upper ? x[q] : x[q + kHalf];
        const float keep = upper ? x[q + kHalf] : x[q];
        x[q] = keep + __shfl_xor_sync(0xffffffffu, send, kHi);
      }
      if (upper) base += kHalf;
      scatter<kHalf, kHi / 2, kLo>(x, lane, base, owner);
    } else {
      x[0] += __shfl_xor_sync(0xffffffffu, x[0], kHi);
      if (lane & kHi) owner = false;
      scatter<1, kHi / 2, kLo>(x, lane, base, owner);
    }
  }
}

// How many of N values a lane holds after scatter over kLanes lanes.
__host__ __device__ constexpr int held(int n, int lanes) {
  return n > lanes ? n / lanes : 1;
}

// ---------------------------------------------------------------- stage 1

template <int kDP>
struct Jump {
  static constexpr int kThreads = kDP * kDP / 32;  // an 8 x 4 tile each
};

template <int kDP>
struct JumpSmem {
  float a[kJ][kDP];   // k (states) or r (gradients), scaled by the decays
  float w[kJ][kDP];
  float x[kJ][kDP];   // v or dy
  float W[kDP];       // the jump's product of decays, per row
};

// Steps tj .. tj + kJ - 1 of a, w and x (each a (b, h) row and its time
// stride) into one stage of the ring.
template <int kDP, bool kVec16>
__device__ __forceinline__ void load_jump(JumpSmem<kDP>& sm, const Args& a,
                                          const float* const (&src)[3],
                                          const long long (&ss)[3], int tj) {
  constexpr int kRow = kVec16 ? kDP / 4 : kDP, kW4 = kVec16 ? 4 : 1;
  float* const dst[3] = {&sm.a[0][0], &sm.w[0][0], &sm.x[0][0]};
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    for (int x = threadIdx.x; x < kJ * kRow; x += Jump<kDP>::kThreads) {
      const int s = x / kRow, c = x % kRow * kW4;
      copy_in<kVec16>(dst[m] + s * kDP + c, src[m], ss[m], m == 1, tj + s, c,
                      a);
    }
  }
}

template <int kDP, bool kVec16>
__global__ void __launch_bounds__(Jump<kDP>::kThreads)
    wkv6_bwd_states_kernel(Args a) {
  constexpr int kPer = kL / kJ;
  extern __shared__ float4 wkv6_bwd_smem[];
  JumpSmem<kDP>* ring = reinterpret_cast<JumpSmem<kDP>*>(wkv6_bwd_smem);
  const int tid = threadIdx.x;
  const bool grads = blockIdx.x == 1;  // G walking back, else S forward
  const int h = blockIdx.y, b = blockIdx.z;
  const int n = a.n_chunks, nz = kPer * (n - 1);
  const int arr_a = grads ? kR : kK, arr_x = grads ? kDY : kV;
  const float* const src[3] = {input(a, arr_a, b, h), input(a, kW, b, h),
                               input(a, arr_x, b, h)};
  const long long ss[3] = {a.ss[arr_a], a.ss[kW], a.ss[arr_x]};
  const int i0 = 8 * (tid / (kDP / 4)), j0 = 4 * (tid % (kDP / 4));

  // the z-th jump's first step: S forward from chunk 0, G back from the
  // last chunk; neither needs the jumps of its last chunk
  auto first_step = [&](int z) {
    return kJ * (grads ? kPer * n - 1 - z : z);
  };
  float s[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = i0 + r, j = j0 + c;
      s[r][c] = grads && a.ds != nullptr && i < a.D && j < a.D
                    ? a.ds[((static_cast<long long>(b) * a.H + h) * a.D + i) *
                               a.D +
                           j]
                    : 0.f;
    }
  float* out = a.states +
               (static_cast<long long>(b) * a.H + h) * n * 2 * kDP * kDP +
               (grads ? kDP * kDP : 0) + i0 * kDP + j0;

#pragma unroll
  for (int z = 0; z < kStages - 1; ++z) {
    if (z < nz) load_jump<kDP, kVec16>(ring[z], a, src, ss, first_step(z));
    cp_async_commit();
  }
  for (int z = 0;; ++z) {
    if (z % kPer == 0) {  // a chunk boundary: S^c, or E^{c+1}, to slot c
      const int c = grads ? n - 1 - z / kPer : z / kPer;
      float* o = out + static_cast<long long>(c) * 2 * kDP * kDP;
#pragma unroll
      for (int r = 0; r < 8; ++r)
        *reinterpret_cast<float4*>(o + r * kDP) =
            make_float4(s[r][0], s[r][1], s[r][2], s[r][3]);
    }
    if (z == nz) break;
    cp_async_wait<kStages - 2>();
    __syncthreads();  // jump z has landed; jump z - 1's stage is free
    if (z + kStages - 1 < nz)
      load_jump<kDP, kVec16>(ring[(z + kStages - 1) % kStages], a, src, ss,
                             first_step(z + kStages - 1));
    cp_async_commit();
    JumpSmem<kDP>& sm = ring[z % kStages];
    for (int i = tid; i < kDP; i += Jump<kDP>::kThreads) {
      // a thread a row: its decay products, a scaled in place
      float q = 1.f;
      if (grads) {
#pragma unroll
        for (int t = 0; t < kJ; ++t) {  // r_t . prod_{tau < t} w_tau
          sm.a[t][i] *= q;
          q *= sm.w[t][i];
        }
      } else {
#pragma unroll
        for (int t = kJ - 1; t >= 0; --t) {  // k_t . prod_{tau > t} w_tau
          sm.a[t][i] *= q;
          q *= sm.w[t][i];
        }
      }
      sm.W[i] = q;
    }
    __syncthreads();
    float acc[8][4] = {};
#pragma unroll
    for (int t = 0; t < kJ; ++t) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sm.a[t][i0]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sm.a[t][i0 + 4]);
      const float4 xv = *reinterpret_cast<const float4*>(&sm.x[t][j0]);
      const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(ar[r], xr[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float wr = sm.W[i0 + r];
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = fmaf(wr, s[r][c], acc[r][c]);
    }
  }
}

// ---------------------------------------------------------------- stage 2

template <int kDP>
struct Chunk {
  static constexpr int kLanes = kDP / 4;            // threads a row pair
  static constexpr int kThreads = kDP / 2 * kLanes;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kIn = kL * kDP;              // floats an input
  static constexpr int kKept = kDP * kDP;           // floats a kept state
  // The block takes chunk after chunk and keeps two layouts of its inputs
  // and kept states, alternating, so the next chunk's inputs load while
  // this chunk's last groups compute.  Layout 0: inputs, then kept
  // states 0 .. 6.  Layout 1 at DP = 64 (where a kept state is as large
  // as an input): kept states 6 .. 0, then inputs, which lie on layout
  // 0's kept states 2 .. 6 (free once group 3 is done), as layout 0's
  // inputs lie on layout 1's kept states 6 .. 2; smaller DP: two areas.
  static constexpr bool kOverlap = kKept >= kIn;
  static constexpr int kOne = 5 * kIn + 7 * kKept;
  static constexpr int kArea = kOverlap ? kOne : 2 * kOne;
  static __device__ __forceinline__ int in_at(int par) {
    return par == 0 ? 0 : kOverlap ? 7 * kKept : kOne;
  }
  static __device__ __forceinline__ int kept_at(int par, int q) {
    return par == 0    ? 5 * kIn + q * kKept
           : kOverlap ? (6 - q) * kKept
                      : kOne + 5 * kIn + q * kKept;
  }
};

template <int kDP>
struct ChunkSmem {
  // the chunk's r, k, w, v, dy ([5][kL][DP]) and S before its steps 8,
  // 16, ..., 56 (each thread's two rows of 4 columns, a float4 each), in
  // two layouts
  float area[Chunk<kDP>::kArea];
  float vdy[kL];
  float bonus[kL];        // sum_i r_t[i] u[i] k_t[i]
  // dv's sums over each warp's rows, 4 steps a buffer
  float dvw[2][Chunk<kDP>::kWarps][kHist][kDP];
};

// The thread's 4 columns 4cg .. 4cg + 3 of a row (shared or global).
__device__ __forceinline__ void get4(const float* row, int cg,
                                     float (&x)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(row + 4 * cg);
  x[0] = f.x, x[1] = f.y, x[2] = f.z, x[3] = f.w;
}

// The inputs of chunk c of (b, h) into `in` ([5][kL][DP]): pairs p0 ..
// p1 - 1 of 8-step groups, one cp.async group each, by threads `first` ..
// `first` + `count` - 1 of the block.
template <int kDP, bool kVec16>
__device__ __forceinline__ void load_chunk(float* in, const Args& a,
                                           long long item, int p0, int p1,
                                           int first, int count) {
  constexpr int kRow = kVec16 ? kDP / 4 : kDP, kW4 = kVec16 ? 4 : 1;
  const int n = a.n_chunks;
  const int c = item % n, h = item / n % a.H, b = item / n / a.H;
  for (int pr = p0; pr < p1; ++pr) {
#pragma unroll
    for (int arr = 0; arr < 5; ++arr) {
      const float* src = input(a, arr, b, h);
      for (int x = threadIdx.x - first; x < 2 * kSub * kRow; x += count) {
        const int s = 2 * kSub * pr + x / kRow, cc = x % kRow * kW4;
        copy_in<kVec16>(in + (arr * kL + s) * kDP + cc, src, a.ss[arr],
                        arr == kW, c * kL + s, cc, a);
      }
    }
    cp_async_commit();
  }
}

// S_t = diag(w_t) S_{t-1} + k_t v_t^T on the thread's rows i0, i0 + 1 and
// columns 4cg .. 4cg + 3, step s of the chunk.
template <int kDP>
__device__ __forceinline__ void step_state(const float* in, int s, int i0,
                                           int cg, float (&st)[2][4]) {
  float vv[4];
  get4(in + (kV * kL + s) * kDP, cg, vv);
  const float2 w2 = *reinterpret_cast<const float2*>(in + (kW * kL + s) *
                                                     kDP + i0);
  const float2 k2 = *reinterpret_cast<const float2*>(in + (kK * kL + s) *
                                                     kDP + i0);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    st[0][e] = fmaf(w2.x, st[0][e], k2.x * vv[e]);
    st[1][e] = fmaf(w2.y, st[1][e], k2.y * vv[e]);
  }
}

template <int kDP, bool kVec16>
__global__ void __launch_bounds__(Chunk<kDP>::kThreads, 1)
    wkv6_bwd_chunks_kernel(Args a) {
  using T = Chunk<kDP>;
  extern __shared__ float4 wkv6_bwd_smem[];
  ChunkSmem<kDP>& sm = *reinterpret_cast<ChunkSmem<kDP>*>(wkv6_bwd_smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = 2 * (tid / T::kLanes), cg = tid % T::kLanes;
  const int n = a.n_chunks;
  const long long total = static_cast<long long>(a.B) * a.H * n;
  constexpr int kOut = kHist * kDP;  // dv outputs of 4 steps
  // threads that sum dv while the others issue the next chunk's loads
  // (every thread does both where there are too few)
  constexpr int kSum = T::kThreads >= 2 * kOut ? kOut : T::kThreads;
  constexpr int kLoad = kSum < T::kThreads ? T::kThreads - kSum : kSum;
  const int load_first = kSum < T::kThreads ? kSum : 0;
  const bool sums = tid < kSum, loads = tid >= load_first;
  // the forward's walkers (4 x 4 tiles) and the first warp that takes
  // vdy and bonus beside them (the one warp, after its walk, at DP = 16)
  constexpr int kWalkers = kDP * kDP / 16;
  constexpr int kVdyWarp = T::kWarps == 1 ? 0 : kWalkers / 32;
  const bool walker = tid < kWalkers;
  int buf = 0, par = 0;
  if (blockIdx.x < total)
    load_chunk<kDP, kVec16>(sm.area + T::in_at(0), a, blockIdx.x, 0,
                            kGroups / 2, 0, T::kThreads);
  for (long long item = blockIdx.x; item < total;
       item += gridDim.x, par ^= 1) {
    const int c = item % n, h = item / n % a.H, b = item / n / a.H;
    const int t0 = c * kL;
    const long long next = item + gridDim.x;
    const float* in = sm.area + T::in_at(par);
    auto row = [&](int arr, int s) { return in + (arr * kL + s) * kDP; };
    auto kept = [&](int q) {
      return reinterpret_cast<float4*>(sm.area + T::kept_at(par, q));
    };
    const float* slot =
        a.states +
        ((static_cast<long long>(b) * a.H + h) * n + c) * 2 * kDP * kDP +
        i0 * kDP;
    const long long ob = b * a.o_sb + h * a.o_sh;
    const float u0 = i0 < a.D ? a.u[static_cast<long long>(h) * a.D + i0]
                              : 0.f;
    const float u1 = i0 + 1 < a.D
                         ? a.u[static_cast<long long>(h) * a.D + i0 + 1]
                         : 0.f;
    float uj[(kDP + 31) / 32];
#pragma unroll
    for (int m = 0; m < (kDP + 31) / 32; ++m) {
      const int j = lane + 32 * m;
      uj[m] = j < a.D ? a.u[static_cast<long long>(h) * a.D + j] : 0.f;
    }
    // forward: the walkers take S from S^c and keep it every 8 steps, 4
    // rows by 4 columns each (fewer shared loads a step than the
    // backward's tiles), writing each kept tile into the slots of the
    // threads that own its row pairs; meanwhile the other warps take
    // vdy_t and bonus_t of every step, a warp a step.  Two groups a wait.
    float st[4][4];
    const int fr = 4 * (tid / T::kLanes);  // a walker's first row
    if (walker) {
#pragma unroll
      for (int r = 0; r < 4; ++r)  // S^c
        get4(a.states +
                 ((static_cast<long long>(b) * a.H + h) * n + c) * 2 * kDP *
                     kDP +
                 (fr + r) * kDP,
             cg, st[r]);
    }
    for (int q = 0; q < kGroups; q += 2) {
      cp_async_wait_groups((kGroups - 2 - q) / 2);
      __syncthreads();  // groups q, q + 1 have landed (every thread's)
      if (walker) {
#pragma unroll
        for (int qq = q; qq < q + 2; ++qq) {
          if (qq > 0) {
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              const int owner = (fr / 2 + m) * T::kLanes + cg;
              kept(qq - 1)[owner] = make_float4(
                  st[2 * m][0], st[2 * m][1], st[2 * m][2], st[2 * m][3]);
              kept(qq - 1)[T::kThreads + owner] =
                  make_float4(st[2 * m + 1][0], st[2 * m + 1][1],
                              st[2 * m + 1][2], st[2 * m + 1][3]);
            }
          }
          if (qq < kGroups - 1) {
#pragma unroll
            for (int s = 0; s < kSub; ++s) {
              const int tl = qq * kSub + s;
              float vv[4];
              get4(row(kV, tl), cg, vv);
              const float4 w4 =
                  *reinterpret_cast<const float4*>(row(kW, tl) + fr);
              const float4 k4 =
                  *reinterpret_cast<const float4*>(row(kK, tl) + fr);
              const float wr[4] = {w4.x, w4.y, w4.z, w4.w};
              const float kr[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
              for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  st[r][e] = fmaf(wr[r], st[r][e], kr[r] * vv[e]);
            }
          }
        }
      }
      if (warp >= kVdyWarp) {
        for (int tl = q * kSub + warp - kVdyWarp; tl < (q + 2) * kSub;
             tl += T::kWarps - kVdyWarp) {
          float vd = 0.f, bo = 0.f;
#pragma unroll
          for (int m = 0; m < (kDP + 31) / 32; ++m) {
            const int j = lane + 32 * m;
            if (j < kDP) {
              vd = fmaf(row(kV, tl)[j], row(kDY, tl)[j], vd);
              bo = fmaf(row(kR, tl)[j] * uj[m], row(kK, tl)[j], bo);
            }
          }
#pragma unroll
          for (int m = 16; m >= 1; m /= 2) {
            vd += __shfl_xor_sync(0xffffffffu, vd, m);
            bo += __shfl_xor_sync(0xffffffffu, bo, m);
          }
          if (lane == 0) sm.vdy[tl] = vd, sm.bonus[tl] = bo;
        }
      }
    }
    float g[2][4];
    get4(slot + kDP * kDP, cg, g[0]);  // E^{c+1}
    get4(slot + kDP * kDP + kDP, cg, g[1]);
    __syncthreads();  // the kept states, vdy and bonus are in

    // backward: G from E^{c+1}, 4 steps at a time, with the 4 states
    // S_{t-1} recomputed from the nearest kept one: dr, dk, dw, dv
    float du0 = 0.f, du1 = 0.f;
    for (int q = kGroups - 1; q >= 0; --q) {
      for (int half = 1; half >= 0; --half) {
        const int s0 = q * kSub + half * kHist;  // the 4 steps' first
        float hist[kHist][2][4];                 // S_{t-1}, t = s0 ..
        {
          float sv[2][4];
          if (q == 0) {
            get4(slot, cg, sv[0]);
            get4(slot + kDP, cg, sv[1]);
          } else {
            const float4 lo = kept(q - 1)[tid];
            const float4 hi = kept(q - 1)[T::kThreads + tid];
            sv[0][0] = lo.x, sv[0][1] = lo.y, sv[0][2] = lo.z, sv[0][3] = lo.w;
            sv[1][0] = hi.x, sv[1][1] = hi.y, sv[1][2] = hi.z, sv[1][3] = hi.w;
          }
          if (half) {
#pragma unroll
            for (int s = 0; s < kHist; ++s)
              step_state<kDP>(in, q * kSub + s, i0, cg, sv);
          }
#pragma unroll
          for (int s = 0; s < kHist; ++s) {
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
              for (int e = 0; e < 4; ++e) hist[s][r][e] = sv[r][e];
            if (s + 1 < kHist) step_state<kDP>(in, s0 + s, i0, cg, sv);
          }
        }
        // row sums of 4 steps x 2 rows: index 2s + r
        float pr[2 * kHist], pk[2 * kHist], pw[2 * kHist];
#pragma unroll
        for (int s = kHist - 1; s >= 0; --s) {
          const int tl = s0 + s;
          float vv[4], dd[4];
          get4(row(kV, tl), cg, vv);
          get4(row(kDY, tl), cg, dd);
          const float2 w2 = *reinterpret_cast<const float2*>(row(kW, tl) + i0);
          const float2 r2 = *reinterpret_cast<const float2*>(row(kR, tl) + i0);
          const float2 k2 = *reinterpret_cast<const float2*>(row(kK, tl) + i0);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float x0 = 0.f, x1 = 0.f, y0 = 0.f, y1 = 0.f, z0 = 0.f, z1 = 0.f;
#pragma unroll
            for (int e = 0; e < 4; e += 2) {
              x0 = fmaf(hist[s][r][e], dd[e], x0);
              x1 = fmaf(hist[s][r][e + 1], dd[e + 1], x1);
              y0 = fmaf(g[r][e], vv[e], y0);
              y1 = fmaf(g[r][e + 1], vv[e + 1], y1);
              z0 = fmaf(hist[s][r][e], g[r][e], z0);
              z1 = fmaf(hist[s][r][e + 1], g[r][e + 1], z1);
            }
            pr[2 * s + r] = x0 + x1;
            pk[2 * s + r] = y0 + y1;
            pw[2 * s + r] = z0 + z1;
          }
          float dvp[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dvp[e] = fmaf(g[1][e], k2.y, g[0][e] * k2.x);
          int base = 0;
          bool own = true;
          scatter<4, 16, T::kLanes>(dvp, lane, base, own);
          float* dst = &sm.dvw[buf][warp][s][4 * cg + base];
          if constexpr (held(4, 32 / T::kLanes) == 2) {
            *reinterpret_cast<float2*>(dst) = make_float2(dvp[0], dvp[1]);
          } else {
            if (own) *dst = dvp[0];
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            g[0][e] = fmaf(w2.x, g[0][e], r2.x * dd[e]);
            g[1][e] = fmaf(w2.y, g[1][e], r2.y * dd[e]);
          }
        }
        {
          int base = 0, base_k = 0, base_w = 0;
          bool own = true, own_k = true, own_w = true;
          scatter<2 * kHist, T::kLanes / 2, 1>(pr, lane, base, own);
          scatter<2 * kHist, T::kLanes / 2, 1>(pk, lane, base_k, own_k);
          scatter<2 * kHist, T::kLanes / 2, 1>(pw, lane, base_w, own_w);
          if (own) {
#pragma unroll
            for (int m = 0; m < held(2 * kHist, T::kLanes); ++m) {
              const int r = (base + m) & 1, i = i0 + r;
              const int tl = s0 + ((base + m) >> 1), t = t0 + tl;
              const float rt = row(kR, tl)[i], kt = row(kK, tl)[i];
              const float vd = sm.vdy[tl];
              const float ui = r ? u1 : u0;
              if (r)
                du1 = fmaf(rt * kt, vd, du1);
              else
                du0 = fmaf(rt * kt, vd, du0);
              if (t < a.S && i < a.D) {
                const long long o = ob + t * a.o_ss + i;
                a.out[kDR][o] = fmaf(ui * kt, vd, pr[m]);
                a.out[kDK][o] = fmaf(rt * ui, vd, pk[m]);
                a.out[kDW][o] = pw[m];
              }
            }
          }
        }
        __syncthreads();  // every warp's dv sums of these 4 steps are in
        if (loads && q <= 2 && q >= 1 && next < total) {
          // groups 3 .. 7 are done with kept states 2 .. 6 (every thread
          // passed group 3's barriers): the next chunk's inputs go there,
          // a pair of groups a half
          const int p0 = 2 * (2 - q) + 1 - half;
          load_chunk<kDP, kVec16>(sm.area + T::in_at(par ^ 1), a, next, p0,
                                  p0 + 1, load_first, kLoad);
        }
        for (int x = tid; sums && x < kOut; x += kSum) {
          const int s = x / kDP, j = x % kDP, tl = s0 + s, t = t0 + tl;
          float sum = 0.f;
#pragma unroll
          for (int wv = 0; wv < T::kWarps; ++wv) sum += sm.dvw[buf][wv][s][j];
          if (t < a.S && j < a.D)
            a.out[kDV][ob + t * a.o_ss + j] =
                fmaf(sm.bonus[tl], row(kDY, tl)[j], sum);
        }
        buf ^= 1;
      }
    }
#pragma unroll
    for (int m = T::kLanes / 2; m >= 1; m /= 2) {
      du0 += __shfl_xor_sync(0xffffffffu, du0, m);
      du1 += __shfl_xor_sync(0xffffffffu, du1, m);
    }
    if (cg == 0) {
      float* dp = a.du_part +
                  ((static_cast<long long>(b) * n + c) * a.H + h) * kDP + i0;
      dp[0] = du0, dp[1] = du1;
    }
  }
}

// du[h][i] = the partials summed over b, then chunks, in order
__global__ void wkv6_bwd_du_kernel(const float* __restrict__ du_part,
                                   float* __restrict__ du, int B, int n,
                                   int H, int D, int DP) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= H * D) return;
  const int h = x / D, i = x % D;
  float s = 0.f;
  for (int b = 0; b < B; ++b)
    for (int c = 0; c < n; ++c)
      s += du_part[((static_cast<long long>(b) * n + c) * H + h) * DP + i];
  du[x] = s;
}

template <int kDP, bool kVec16>
cudaError_t launch(const Args& a, cudaStream_t s) {
  cudaError_t err;
  if (a.n_chunks > 0) {
    constexpr int kRing = kStages * sizeof(JumpSmem<kDP>);
    err = cudaFuncSetAttribute(wkv6_bwd_states_kernel<kDP, kVec16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kRing);
    if (err != cudaSuccess) return err;
    wkv6_bwd_states_kernel<kDP, kVec16>
        <<<dim3(2, a.H, a.B), Jump<kDP>::kThreads, kRing, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    constexpr int kSmem = sizeof(ChunkSmem<kDP>);
    err = cudaFuncSetAttribute(wkv6_bwd_chunks_kernel<kDP, kVec16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (err != cudaSuccess) return err;
    // as many blocks as fit on the card at once, each taking chunk after
    // chunk
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, wkv6_bwd_chunks_kernel<kDP, kVec16>, Chunk<kDP>::kThreads,
        kSmem);
    if (err != cudaSuccess) return err;
    const long long items =
        static_cast<long long>(a.B) * a.H * a.n_chunks;
    const int grid = static_cast<int>(
        items < static_cast<long long>(sms) * per_sm ? items
                                                     : sms * per_sm);
    wkv6_bwd_chunks_kernel<kDP, kVec16>
        <<<grid, Chunk<kDP>::kThreads, kSmem, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int hd = a.H * a.D;
  wkv6_bwd_du_kernel<<<(hd + 255) / 256, 256, 0, s>>>(
      a.du_part, a.du, a.B, a.n_chunks, a.H, a.D, kDP);
  return cudaGetLastError();
}

template <int kDP>
cudaError_t launch_dp(const Args& a, bool vec16, cudaStream_t s) {
  return vec16 ? launch<kDP, true>(a, s) : launch<kDP, false>(a, s);
}

}  // namespace

extern "C" {

const char* wkv6_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// float32 throughout; ds_final may be null (zero).  states: float32
// scratch of B * H * ceil(S / 64) * 2 * DP * DP, du_part: of B * ceil(S /
// 64) * H * DP, DP the head size rounded up to 16, 32 or 64.  vec16: every
// (b, h, t) stride of r, k, v, w and dy a multiple of 4 elements and their
// bases on 16 bytes (16-byte copies), else 0 (4-byte copies).
int wkv6_bwd(const float* r, const float* k, const float* v, const float* w,
             const float* u, const float* dy, const float* ds_final,
             float* dr, float* dk, float* dv, float* dw, float* du,
             float* states, float* du_part, int B, int H, int S, int D,
             int vec16, long long r_sb, long long r_sh, long long r_ss,
             long long k_sb, long long k_sh, long long k_ss, long long v_sb,
             long long v_sh, long long v_ss, long long w_sb, long long w_sh,
             long long w_ss, long long dy_sb, long long dy_sh,
             long long dy_ss, long long o_sb, long long o_sh, long long o_ss,
             void* stream) {
  if (D % 16 != 0 || D < 16 || D > 64 || B < 0 || H < 0 || S < 0 ||
      B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  Args a{};
  a.in[kR] = r, a.in[kK] = k, a.in[kW] = w, a.in[kV] = v, a.in[kDY] = dy;
  const long long sb[5] = {r_sb, k_sb, w_sb, v_sb, dy_sb};
  const long long sh[5] = {r_sh, k_sh, w_sh, v_sh, dy_sh};
  const long long ss[5] = {r_ss, k_ss, w_ss, v_ss, dy_ss};
  for (int x = 0; x < 5; ++x) {
    a.sb[x] = sb[x], a.sh[x] = sh[x], a.ss[x] = ss[x];
    if (vec16 && (sb[x] % 4 || sh[x] % 4 || ss[x] % 4 ||
                  reinterpret_cast<uintptr_t>(a.in[x]) % 16))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  a.u = u, a.ds = ds_final;
  a.out[kDR] = dr, a.out[kDK] = dk, a.out[kDV] = dv, a.out[kDW] = dw;
  a.o_sb = o_sb, a.o_sh = o_sh, a.o_ss = o_ss;
  a.du = du, a.states = states, a.du_part = du_part;
  a.B = B, a.H = H, a.S = S, a.D = D, a.n_chunks = (S + kL - 1) / kL;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool v16 = vec16 != 0;
  if (D <= 16) return static_cast<int>(launch_dp<16>(a, v16, s));
  if (D <= 32) return static_cast<int>(launch_dp<32>(a, v16, s));
  return static_cast<int>(launch_dp<64>(a, v16, s));
}

}  // extern "C"
