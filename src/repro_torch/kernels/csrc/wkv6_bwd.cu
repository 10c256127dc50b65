// RWKV-6 (Finch) WKV backward, hand-written for Hopper (sm_90a).
//
// No TPU kernel: the reference trains through jax.vjp of its training form,
// wkv6_chunked (src/repro/models/rwkv6.py), which runs kref.wkv6
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
// All float32, the training form's dtypes.  r, k, v, w and dy are read
// through element strides (b, h, t) with a contiguous D axis; dr, dk, dv
// and dw are written through one set of strides (the wrapper gives (B, S,
// H, D) memory), du (H, D) contiguous.
//
// Every row i of S and G evolves alone (its decay w_t[i] is a scalar), and
// dr, dk and dw reduce along a row; only dv reduces across rows.  So three
// kernels, on the caller's stream:
//
// wkv6_bwd_rows_kernel: one block per 16 rows of one (b, h), 16 threads a
//   row, each holding D / 16 columns (j = p + 16 e) of S and G in
//   registers.  Time is staged 16 steps a chunk in shared memory (r, k, w
//   of the block's rows, v and dy of every column, vdy).  Pass A walks the
//   chunks forward: it writes S before each chunk to a float32 checkpoint
//   (B x H x ceil(S / 16) x D x D floats: 537 MB at rwkv6-7b's training
//   shape B = 2, H = 64, S = 4096, D = 64) and takes dr.  Pass B walks the
//   chunks back: it reloads the chunk's checkpoint, recomputes the chunk's
//   16 states S_{t-1} into registers, and walks them back with G for dk
//   and dw, and the row's du terms.  A thread sums its 16 steps' partial
//   products first and then reduces them over the row's 16 threads in one
//   butterfly (15 shuffles for 16 sums, each lane left with one step's),
//   not 4 shuffles a sum.  The row's du terms add up per lane, and the 16
//   lanes' sums in a fixed order into one partial per (b, h, row).
// wkv6_bwd_dv_kernel: one block per (b, h) in the forward's layout (thread
//   (j, q) holds column j of G, rows 16 m + 4 q + e, 4 D threads), walking
//   time back in chunks of 32 staged steps: dv_t[j] = sum_i k_t[i] (G_t[i][j]
//   + r_t[i] u[i] dy_t[j]), the column's sum, two shuffles over the 4
//   threads of a column.  It needs no S, so no checkpoint.
// wkv6_bwd_du_kernel: du[h][i] = sum over b of the partials, in order of
//   b: no atomics, so two calls are bitwise equal.
//
// Bound: at the training shape, r, k, v, w, dy and the four gradients are
// 9 x 134 MB (0.36 ms at 3.35 TB/s); the work the gradients need is ~8 D^2
// operations a step and head for the two reductions of S and G beside
// their updates (~17 GFLOP, 0.26 ms at 67 TFLOP/s on the CUDA cores).
// Recomputing S twice (pass A and pass B) and the checkpoint's round trip
// (1.07 GB) cost about as much again; a simple kernel that is right first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kL = 16;        // steps a chunk of the rows kernel
constexpr int kRowsB = 16;    // rows of S a block of the rows kernel
constexpr int kLanes = 16;    // threads a row
constexpr int kThreads = kRowsB * kLanes;
constexpr int kSplit = 4;     // dv kernel: threads a column
constexpr int kTdv = 32;      // dv kernel: steps staged a chunk

struct Args {
  const float* r;
  const float* k;
  const float* v;
  const float* w;
  const float* u;
  const float* dy;
  const float* ds;  // (B, H, D, D) or null
  float* dr;
  float* dk;
  float* dv;
  float* dw;
  float* du;        // (H, D)
  float* ckpt;      // (B, H, n_chunks, D, D)
  float* du_part;   // (B, H, D)
  int B, H, S;
  long long r_sb, r_sh, r_ss;  // element strides; the D axis is contiguous
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long w_sb, w_sh, w_ss;
  long long dy_sb, dy_sh, dy_ss;
  long long o_sb, o_sh, o_ss;  // of dr, dk, dv and dw
};

// Sums of 16 values over the 16 lanes of a row: lane p (its bit pattern
// within the half warp) is left holding, in v[0], the sum of every lane's
// v[p].  Each stage hands the partner lane the half it keeps.
__device__ __forceinline__ void row_reduce_scatter(float (&v)[kL]) {
#pragma unroll
  for (int m = kL / 2; m >= 1; m /= 2) {
    const bool upper = threadIdx.x & m;
#pragma unroll
    for (int q = 0; q < m; ++q) {
      const float send = upper ? v[q] : v[q + m];
      const float keep = upper ? v[q + m] : v[q];
      v[q] = keep + __shfl_xor_sync(0xffffffffu, send, m);
    }
  }
}

template <int kD>
struct RowsSmem {
  float r[kL][kRowsB];
  float k[kL][kRowsB];
  float w[kL][kRowsB];
  float v[kL][kD];
  float dy[kL][kD];
  float vdy[kL];
  float out[2][kL][kRowsB + 1];  // a chunk's sums on their way out
};

// Steps t0 .. t0 + kL - 1 into shared memory: the block's rows of r, k and
// w, every column of v and dy, and vdy_t; steps past S as r = k = v = dy =
// 0 and w = 1, which leave S and G as they are.
template <int kD>
__device__ __forceinline__ void stage_rows(RowsSmem<kD>& sm, const Args& a,
                                           int b, int h, int i0, int t0) {
  const int tid = threadIdx.x;
  const long long rb = b * a.r_sb + h * a.r_sh, kb = b * a.k_sb + h * a.k_sh;
  const long long vb = b * a.v_sb + h * a.v_sh, wb = b * a.w_sb + h * a.w_sh;
  const long long db = b * a.dy_sb + h * a.dy_sh;
  {
    const int s = tid / kRowsB, i = tid % kRowsB;  // kThreads = kL * kRowsB
    const long long t = t0 + s;
    const bool ok = t < a.S;
    sm.r[s][i] = ok ? a.r[rb + t * a.r_ss + i0 + i] : 0.f;
    sm.k[s][i] = ok ? a.k[kb + t * a.k_ss + i0 + i] : 0.f;
    sm.w[s][i] = ok ? a.w[wb + t * a.w_ss + i0 + i] : 1.f;
  }
  for (int x = tid; x < kL * kD; x += kThreads) {
    const int s = x / kD, j = x % kD;
    const long long t = t0 + s;
    const bool ok = t < a.S;
    sm.v[s][j] = ok ? a.v[vb + t * a.v_ss + j] : 0.f;
    sm.dy[s][j] = ok ? a.dy[db + t * a.dy_ss + j] : 0.f;
  }
  __syncthreads();
  {  // vdy: 16 lanes a step
    const int s = tid / kLanes, p = tid % kLanes;
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < kD / kLanes; ++e)
      part = fmaf(sm.v[s][p + kLanes * e], sm.dy[s][p + kLanes * e], part);
#pragma unroll
    for (int m = kLanes / 2; m >= 1; m /= 2)
      part += __shfl_xor_sync(0xffffffffu, part, m);
    if (p == 0) sm.vdy[s] = part;
  }
  __syncthreads();
}

// sm.out[o] (step s, row i) to steps t0 .. of rows i0 .. of dst, those
// below S
template <int kD>
__device__ __forceinline__ void store_rows(RowsSmem<kD>& sm, int o,
                                           float* dst, const Args& a, int b,
                                           int h, int i0, int t0) {
  const int s = threadIdx.x / kRowsB, i = threadIdx.x % kRowsB;
  const long long t = t0 + s;
  if (t < a.S) dst[b * a.o_sb + h * a.o_sh + t * a.o_ss + i0 + i] =
      sm.out[o][s][i];
}

template <int kD>
__global__ void __launch_bounds__(kThreads)
    wkv6_bwd_rows_kernel(Args a) {
  constexpr int kC = kD / kLanes;  // columns a thread: j = p + 16 e
  __shared__ __align__(16) RowsSmem<kD> sm;
  const int p = threadIdx.x % kLanes, row = threadIdx.x / kLanes;
  const int i0 = blockIdx.x * kRowsB, i = i0 + row;
  const int h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = (a.S + kL - 1) / kL;
  const float u = a.u[static_cast<long long>(h) * kD + i];
  float* ck = a.ckpt + (static_cast<long long>(b) * a.H + h) * n_chunks *
                           static_cast<long long>(kD * kD) +
              static_cast<long long>(i) * kD;

  // pass A: forward; the state before each chunk to the checkpoint, dr
  float st[kC];
#pragma unroll
  for (int e = 0; e < kC; ++e) st[e] = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kL;
    __syncthreads();  // the previous chunk's readers are done
    stage_rows<kD>(sm, a, b, h, i0, t0);
#pragma unroll
    for (int e = 0; e < kC; ++e)
      ck[static_cast<long long>(c) * kD * kD + p + kLanes * e] = st[e];
    float part[kL];
#pragma unroll
    for (int s = 0; s < kL; ++s) {
      const float ws = sm.w[s][row], ks = sm.k[s][row];
      part[s] = 0.f;
#pragma unroll
      for (int e = 0; e < kC; ++e) {
        const int j = p + kLanes * e;
        part[s] = fmaf(st[e], sm.dy[s][j], part[s]);
        st[e] = fmaf(ws, st[e], ks * sm.v[s][j]);
      }
    }
    row_reduce_scatter(part);  // lane p: step p
    sm.out[0][p][row] = fmaf(u * sm.k[p][row], sm.vdy[p], part[0]);
    __syncthreads();
    store_rows<kD>(sm, 0, a.dr, a, b, h, i0, t0);
  }

  // pass B: backward; dk, dw and the du terms
  float g[kC];
#pragma unroll
  for (int e = 0; e < kC; ++e)
    g[e] = a.ds == nullptr
               ? 0.f
               : a.ds[((static_cast<long long>(b) * a.H + h) * kD + i) * kD +
                      p + kLanes * e];
  float du = 0.f;  // lane p: the row's terms of step p of every chunk
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kL;
    __syncthreads();  // the previous chunk's readers are done
    stage_rows<kD>(sm, a, b, h, i0, t0);
    float hist[kL][kC];  // S_{t-1} for the chunk's steps
#pragma unroll
    for (int e = 0; e < kC; ++e)
      st[e] = ck[static_cast<long long>(c) * kD * kD + p + kLanes * e];
#pragma unroll
    for (int s = 0; s < kL; ++s) {
      const float ws = sm.w[s][row], ks = sm.k[s][row];
#pragma unroll
      for (int e = 0; e < kC; ++e) {
        hist[s][e] = st[e];
        st[e] = fmaf(ws, st[e], ks * sm.v[s][p + kLanes * e]);
      }
    }
    float pk[kL], pw[kL];
#pragma unroll
    for (int s = kL - 1; s >= 0; --s) {
      const float ws = sm.w[s][row], rs = sm.r[s][row];
      pk[s] = 0.f;
      pw[s] = 0.f;
#pragma unroll
      for (int e = 0; e < kC; ++e) {
        const int j = p + kLanes * e;
        pk[s] = fmaf(g[e], sm.v[s][j], pk[s]);
        pw[s] = fmaf(hist[s][e], g[e], pw[s]);
        g[e] = fmaf(ws, g[e], rs * sm.dy[s][j]);
      }
    }
    row_reduce_scatter(pk);
    row_reduce_scatter(pw);
    const float rk = sm.r[p][row] * u;
    sm.out[0][p][row] = fmaf(rk, sm.vdy[p], pk[0]);
    sm.out[1][p][row] = pw[0];
    du = fmaf(sm.r[p][row] * sm.k[p][row], sm.vdy[p], du);
    __syncthreads();
    store_rows<kD>(sm, 0, a.dk, a, b, h, i0, t0);
    store_rows<kD>(sm, 1, a.dw, a, b, h, i0, t0);
  }
#pragma unroll
  for (int m = 1; m < kLanes; m *= 2)
    du += __shfl_xor_sync(0xffffffffu, du, m);
  if (p == 0)
    a.du_part[(static_cast<long long>(b) * a.H + h) * kD + i] = du;
}

template <int kD>
__global__ void __launch_bounds__(kD * kSplit) wkv6_bwd_dv_kernel(Args a) {
  constexpr int kThreadsDv = kD * kSplit;
  constexpr int kVec = kD / 16;  // float4 groups of rows per thread
  constexpr int kRows = 4 * kVec;
  __shared__ __align__(16) float rs[kTdv][kD];
  __shared__ __align__(16) float ks[kTdv][kD];
  __shared__ __align__(16) float ws[kTdv][kD];
  __shared__ __align__(16) float dys[kTdv][kD];

  const int tid = threadIdx.x;
  const int j = tid / kSplit;  // column of G
  const int q = tid % kSplit;  // row group
  const int h = blockIdx.x, b = blockIdx.y;
  const float* r = a.r + b * a.r_sb + h * a.r_sh;
  const float* k = a.k + b * a.k_sb + h * a.k_sh;
  const float* w = a.w + b * a.w_sb + h * a.w_sh;
  const float* dy = a.dy + b * a.dy_sb + h * a.dy_sh;
  const float* u = a.u + static_cast<long long>(h) * kD;
  float* dv = a.dv + b * a.o_sb + h * a.o_sh;

  float g[kRows], ur[kRows];
#pragma unroll
  for (int m = 0; m < kVec; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ur[4 * m + e] = u[16 * m + 4 * q + e];
      g[4 * m + e] =
          a.ds == nullptr
              ? 0.f
              : a.ds[((static_cast<long long>(b) * a.H + h) * kD + 16 * m +
                      4 * q + e) *
                         kD +
                     j];
    }

  const int n_chunks = (a.S + kTdv - 1) / kTdv;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kTdv;
    const int n = min(kTdv, a.S - t0);
    __syncthreads();  // the previous chunk's readers are done
    for (int x = tid; x < kTdv * kD; x += kThreadsDv) {
      const int tt = x / kD, d = x - tt * kD;
      const bool ok = tt < n;
      const long long t = t0 + tt;
      rs[tt][d] = ok ? r[t * a.r_ss + d] : 0.f;
      ks[tt][d] = ok ? k[t * a.k_ss + d] : 0.f;
      ws[tt][d] = ok ? w[t * a.w_ss + d] : 1.f;
      dys[tt][d] = ok ? dy[t * a.dy_ss + d] : 0.f;
    }
    __syncthreads();
    for (int tt = n - 1; tt >= 0; --tt) {
      const float dyj = dys[tt][j];
      float part = 0.f;
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
          // k_i (G_t[i][j] + r_i u_i dy_j): the state's and the bonus's
          // terms of dv_t[j] together
          float& gg = g[4 * m + e];
          part = fmaf(kk[e], fmaf(rr[e] * ur[4 * m + e], dyj, gg), part);
          gg = fmaf(ww[e], gg, rr[e] * dyj);
        }
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      if (q == 0) dv[(t0 + tt) * a.o_ss + j] = part;
    }
  }
}

__global__ void wkv6_bwd_du_kernel(const float* __restrict__ du_part,
                                   float* __restrict__ du, int B, int HD) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= HD) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += du_part[static_cast<long long>(b) * HD + x];
  du[x] = s;
}

template <int kD>
cudaError_t launch(const Args& a, cudaStream_t s) {
  wkv6_bwd_rows_kernel<kD>
      <<<dim3(kD / kRowsB, a.H, a.B), kThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv6_bwd_dv_kernel<kD><<<dim3(a.H, a.B), kD * kSplit, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int hd = a.H * kD;
  wkv6_bwd_du_kernel<<<(hd + 255) / 256, 256, 0, s>>>(a.du_part, a.du, a.B,
                                                      hd);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* wkv6_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// float32 throughout; ds_final may be null (zero).  ckpt: float32 scratch
// of B * H * ceil(S / 16) * D * D; du_part: float32 scratch of B * H * D.
int wkv6_bwd(const float* r, const float* k, const float* v, const float* w,
             const float* u, const float* dy, const float* ds_final,
             float* dr, float* dk, float* dv, float* dw, float* du,
             float* ckpt, float* du_part, int B, int H, int S, int D,
             long long r_sb, long long r_sh, long long r_ss, long long k_sb,
             long long k_sh, long long k_ss, long long v_sb, long long v_sh,
             long long v_ss, long long w_sb, long long w_sh, long long w_ss,
             long long dy_sb, long long dy_sh, long long dy_ss,
             long long o_sb, long long o_sh, long long o_ss, void* stream) {
  if (D % 16 != 0 || D < 16 || D > 64 || B < 0 || H < 0 || S < 0 ||
      B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  const Args a{r,     k,     v,     w,     u,     dy,    ds_final, dr,
               dk,    dv,    dw,    du,    ckpt,  du_part, B,     H,
               S,     r_sb,  r_sh,  r_ss,  k_sb,  k_sh,  k_ss,   v_sb,
               v_sh,  v_ss,  w_sb,  w_sh,  w_ss,  dy_sb, dy_sh,  dy_ss,
               o_sb,  o_sh,  o_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return static_cast<int>(launch<16>(a, s));
    case 32: return static_cast<int>(launch<32>(a, s));
    case 48: return static_cast<int>(launch<48>(a, s));
    case 64: return static_cast<int>(launch<64>(a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
