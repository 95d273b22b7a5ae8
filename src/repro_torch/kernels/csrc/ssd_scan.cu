// Mamba-2 SSD chunked scan for Hopper (sm_90a), as a chain of three kernels,
// for f32 inputs; bf16 inputs run stages 1 and 3 of csrc/ssd_scan_sm90.cu
// (on the bf16 tensor cores) and share stage 2 with f32.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan_chunked
// (_ssd_kernel); the plain versions are src/repro_torch/kernels/ref.py::
// ssd_scan_chunked_ref (the whole scan) and ssd_chunk_states_ref,
// ssd_pass_states_ref, ssd_chunk_output_ref (one per kernel). The model calls
// it from src/repro_torch/models/ssm.py::apply_ssm under use_kernel.
//
// What it computes, per (batch, head), in f32 (cum is the within-chunk
// cumulative sum of dt*A, computed by the wrapper as the TPU wrapper does):
//   y_i    = sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) dt_j x_j + exp(cum_i) C_i.state
//   state <- exp(cum_last) state + sum_j exp(cum_last - cum_j) dt_j B_j (x) x_j
// with the f32 state [N, P] carried from chunk to chunk. The TPU kernel's
// a_head input is never read in its body, so these kernels do not take it.
//
// Design. The TPU grid (B, head blocks, chunks) ran its chunk steps in order
// with the state in VMEM scratch: the sequential grid was the recurrence. On
// 132 SMs that order is the trouble, so the recurrence is split into the
// chunk-parallel form GPU Mamba-2 uses:
//   1. ssd_chunk_state, grid (chunks, head blocks, B): each chunk's own state
//      Sc = sum_j exp(cum_last - cum_j) dt_j B_j (x) x_j, [N, P] f32 per head,
//      into scratch [B, nc, H, N, P]. B's chunk is staged once per block and
//      shared by its heads (B and C carry no head dimension).
//   2. ssd_state_pass, grid (tiles of N*P, H, B): one thread per state
//      element walks the chunks, state_in[c] = s, s = exp(cum_last[c]) s + Sc[c],
//      in place over the scratch.
//   3. ssd_chunk_output, grid (chunks, head blocks, B): the block computes
//      C.B^T [Q, Q] of its chunk once, in registers, for its 16 heads; per
//      head it forms W = C.B^T o exp(cum_i - cum_j) dt_j for j <= i (above
//      the diagonal the exp can overflow to inf, and inf * 0 is NaN) and
//      y = exp(cum_i) C.state_in + W.x in one register tile, C.state_in for
//      two heads at a time so that they share the loads of C.
// All three run f32 FMA on register micro-tiles fed by 16-byte shared-memory
// loads (8x4 outputs a thread; 8x4 for two heads in C.state_in). Staging is
// latency-bound, so rows are staged with cp.async (all in flight at once)
// and transposed ones with 4-element loads, 8 in flight per thread. Chunks up to 128, head dims up to 64, state sizes up to 128,
// zero-padded to those tiles.
//
// Bound. The function needs, per (batch, chunk), the lower triangle of C.B^T
// (Q(Q+1)N operations) and per head the lower-triangular W.x (Q(Q+1)P), C.state
// and the state's update (2QNP each). At Mamba2-370M's prefill (B 4, S 2048,
// H 32, P 64, N 128, Q 128) that is 10.9 GFLOP: 0.16 ms at the 67 TFLOP/s of
// f32 FMA, against 0.04 ms for the 0.15 GB of x, y, dt, cum, B and C at 3.35
// TB/s. The chain adds the scratch's round trips (67 MB written by 1, read
// and written by 2, read by 3: 0.08 ms) and computes the whole C.B^T square,
// once per block of 16 heads.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QM = 128;       // largest chunk
constexpr int PM = 64;        // largest head dim
constexpr int NM = 128;       // largest state
constexpr int HB1 = 8;        // heads per block of kernel 1
constexpr int HB3 = 16;       // heads per block of kernel 3 (pairs)
constexpr int THREADS = 256;  // 16 x 16
constexpr int QP = QM + 4;    // padded row of the transposed tiles (16-byte aligned)

__device__ __forceinline__ float to_f32(float v) { return v; }

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

// Four results to p[0..3] of a row: one store where every row starts
// 16-byte aligned (``vec``), else element by element up to ``n``.
__device__ __forceinline__ void store4(float* p, const float (&v)[4], bool vec, int n) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int k = 0; k < n && k < 4; ++k) p[k] = v[k];
  }
}

// Four consecutive elements as f32: one 16-byte load.
__device__ __forceinline__ float4 load4g(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// Stage a row-major [rows, cols] block of src (row stride `stride`) into
// shared memory as f32: dst[r][c] with row length ld, or with `transpose`
// dst[c][r]. Rows up to rows_pad and columns up to cols_pad (a multiple of 4)
// are zero past the block. The global loads move four elements each, U of
// them in flight per thread before any store: the staging is latency-bound,
// and this keeps it short.
template <int NT, typename T, int U = 8>
__device__ __forceinline__ void stage(float* dst, int ld, bool transpose, const T* src,
                                      long long stride, int rows, int rows_pad, int cols,
                                      int cols_pad) {
  const bool vec = cols % 4 == 0 && stride % 4 == 0;
  const int c4 = cols_pad / 4, total = rows_pad * c4;
  // consecutive threads take consecutive columns, or with `transpose`
  // consecutive rows, so that their shared-memory stores hit distinct banks
  auto at = [&](int idx, int& r, int& c) {
    if (transpose) { r = idx % rows_pad; c = 4 * (idx / rows_pad); }
    else { r = idx / c4; c = 4 * (idx % c4); }
  };
  for (int base = threadIdx.x; base < total; base += NT * U) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * NT;
      int r, c;
      at(idx, r, c);
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (idx < total && r < rows && c < cols) {
        const T* p = src + r * stride + c;
        if (vec) {
          v[u] = load4g(p);
        } else {
          v[u].x = to_f32(p[0]);
          if (c + 1 < cols) v[u].y = to_f32(p[1]);
          if (c + 2 < cols) v[u].z = to_f32(p[2]);
          if (c + 3 < cols) v[u].w = to_f32(p[3]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * NT;
      if (idx >= total) break;
      int r, c;
      at(idx, r, c);
      if (transpose) {
        const float e[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (c + k < cols) dst[(c + k) * ld + r] = e[k];
      } else {
        *reinterpret_cast<float4*>(&dst[r * ld + c]) = v[u];
      }
    }
  }
}

// Stage an f32 block as `stage` does (no transpose), with
// cp.async 16-byte copies where the rows allow them: every copy of the block
// is in flight at once and costs no registers. Complete after stage_wait().
template <int NT>
__device__ __forceinline__ void stage_f32(float* dst, int ld, const float* src, long long stride,
                                          int rows, int rows_pad, int cols, int cols_pad) {
  if (cols % 4 != 0 || stride % 4 != 0) {  // rows not 16-byte aligned
    stage<NT>(dst, ld, false, src, stride, rows, rows_pad, cols, cols_pad);
    return;
  }
  const int c4 = cols_pad / 4, total = rows_pad * c4;
  for (int idx = threadIdx.x; idx < total; idx += NT) {
    const int r = idx / c4, c = 4 * (idx % c4);
    const bool in = r < rows && c < cols;  // else a zero fill: 0 bytes read
    const uint32_t to = static_cast<uint32_t>(__cvta_generic_to_shared(&dst[r * ld + c]));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to),
                 "l"(in ? src + r * stride + c : src), "r"(in ? 16 : 0));
  }
}

// Wait for this thread's cp.async copies; a __syncthreads() must follow.
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Kernel 1. st [B, nc, H, N, P] f32 <- each chunk's own state.
// Thread (ty, tx) owns state rows n = 8ty + r and columns p = 4tx + cc.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)  // two blocks an SM: at most 128 registers
ssd_chunk_state(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ cum, const T* __restrict__ bm,
                float* __restrict__ st, int S, int H, int P, int N, int Q) {
  extern __shared__ float smem[];
  float* Bs = smem;            // [Q][NM], B_j[n]
  float* Xs = Bs + Q * NM;     // [Q][PM], w_j x_j[p]
  float* w_s = Xs + Q * PM;    // [Q]: exp(cum_last - cum_j) dt_j

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int c = blockIdx.x, b = blockIdx.z, nc = S / Q;
  const long long row0 = static_cast<long long>(b) * S + static_cast<long long>(c) * Q;

  stage<THREADS>(Bs, NM, false, bm + row0 * N, N, Q, Q, N, NM);
  const int h_end = min(H, (blockIdx.y + 1) * HB1);
  for (int h = blockIdx.y * HB1; h < h_end; ++h) {
    __syncthreads();  // Bs is staged; the previous head is done with Xs and w_s
    const T* xh = x + (row0 * H + h) * P;
    const long long xs = static_cast<long long>(H) * P;
    if constexpr (sizeof(T) == 4)
      stage_f32<THREADS>(Xs, PM, reinterpret_cast<const float*>(xh), xs, Q, Q, P, PM);
    else
      stage<THREADS>(Xs, PM, false, xh, xs, Q, Q, P, PM);
    const float cum_last = cum[(row0 + Q - 1) * H + h];
    for (int j = tid; j < Q; j += THREADS)
      w_s[j] = expf(cum_last - cum[(row0 + j) * H + h]) * dt[(row0 + j) * H + h];
    stage_wait();
    __syncthreads();
    for (int idx = tid; idx < Q * PM / 4; idx += THREADS) {  // x_j <- w_j x_j
      float4& v = reinterpret_cast<float4*>(Xs)[idx];
      const float w = w_s[idx / (PM / 4)];
      v.x *= w; v.y *= w; v.z *= w; v.w *= w;
    }
    __syncthreads();
    float acc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) acc[r][cc] = 0.f;
#pragma unroll 4
    for (int j = 0; j < Q; ++j) {
      float bv[8], xv[4];
      load8(&Bs[j * NM + ty * 8], bv);
      load4(&Xs[j * PM + tx * 4], xv);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[r][cc] = fmaf(bv[r], xv[cc], acc[r][cc]);
    }
    float* out = st + ((static_cast<long long>(b) * nc + c) * H + h) * N * P;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int n = ty * 8 + r;
      if (n < N && tx * 4 < P) store4(out + n * P + tx * 4, acc[r], P % 4 == 0, P - tx * 4);
    }
  }
}

// Kernel 2. In place over st [B, nc, H, N, P]: Sc[c] becomes state_in[c].
// The loads of 8 chunks are issued before the walk over them, so that each
// thread keeps 8 reads in flight.
__global__ void __launch_bounds__(THREADS)
ssd_state_pass(float* __restrict__ st, const float* __restrict__ cum, int S, int H, int NP,
               int Q) {
  constexpr int G = 8;
  const int e = blockIdx.x * THREADS + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, nc = S / Q;
  if (e >= NP) return;
  float* base = st + (static_cast<long long>(b) * nc * H + h) * NP + e;  // chunk c at c*H*NP
  const long long step = static_cast<long long>(H) * NP;
  float s = 0.f;
  for (int c0 = 0; c0 < nc; c0 += G) {
    float own[G], lam[G];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int c = c0 + u;
      if (c < nc) {
        own[u] = base[c * step];
        lam[u] = expf(cum[(static_cast<long long>(b) * S + c * Q + Q - 1) * H + h]);
      }
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      if (c0 + u < nc) {
        base[(c0 + u) * step] = s;
        s = fmaf(lam[u], s, own[u]);
      }
    }
  }
}

// Rows of the y tile of thread row ty: 4 from the top of the chunk and 4
// mirrored from the bottom, so that every thread row does the same work in
// the lower-triangular W.x.
__device__ __forceinline__ int y_row(int ty, int r) { return r < 4 ? 4 * ty + r : 124 - 4 * ty + r - 4; }

// acc (rows y_row(ty, r), columns 4tx + cc) += W.x, W^T and x in shared
// memory: all 8 rows while the top 4 see j, then the bottom 4 alone.
__device__ __forceinline__ void add_w_times_x(float (&acc)[8][4], const float* Wt,
                                              const float* Xs, int Q, int ty, int tx) {
  const int lo = 4 * ty, hi = 124 - 4 * ty;
  const int j_top = min(Q, lo + 4), j_end = min(Q, hi + 4);
#pragma unroll 4
  for (int j = 0; j < j_top; ++j) {
    float wa[4], wb[4], xv[4];
    load4(&Wt[j * QP + lo], wa);
    load4(&Wt[j * QP + hi], wb);
    load4(&Xs[j * PM + tx * 4], xv);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        acc[r][cc] = fmaf(wa[r], xv[cc], acc[r][cc]);
        acc[r + 4][cc] = fmaf(wb[r], xv[cc], acc[r + 4][cc]);
      }
  }
#pragma unroll 4
  for (int j = j_top; j < j_end; ++j) {
    float wb[4], xv[4];
    load4(&Wt[j * QP + hi], wb);
    load4(&Xs[j * PM + tx * 4], xv);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) acc[r + 4][cc] = fmaf(wb[r], xv[cc], acc[r + 4][cc]);
  }
}

// Kernel 3. y [B, S, H, P] from x, dt, cum, B, C and state_in [B, nc, H, N, P].
// C.B^T: thread (ty, tx) owns rows i = 8ty + r and columns j = tx + 16cc, in
// registers for all the block's heads; of y it owns rows y_row(ty, r) and
// columns p = 4tx + cc. Heads go in pairs: exp(cum_i) C.state_in
// of both heads in one pass over C (8 rows x 4 columns x 2 heads a thread, the
// C loads shared), then per head W^T into shared memory and y += W.x.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_output(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ cum, const T* __restrict__ bm,
                 const T* __restrict__ cm, const float* __restrict__ st, T* __restrict__ y,
                 int S, int H, int P, int N, int Q) {
  extern __shared__ float smem[];
  const int NQ = max(N, Q);
  float* Ct = smem;                 // [N][QP], Ct[n][i] = C_i[n]
  float* Rt = Ct + N * QP;          // [NQ][QP]: Bt[n][j], then Wt[j][i] = W[i][j]
  float* S0 = Rt + NQ * QP;         // [NQ][PM]: state_in of the first head, then x
  float* S1 = S0 + NQ * PM;         // [NQ][PM]: state_in of the second head, then its x
  float* cum_s = S1 + NQ * PM;      // [2][QM]
  float* dt_s = cum_s + 2 * QM;     // [2][QM]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int c = blockIdx.x, b = blockIdx.z, nc = S / Q;
  const long long row0 = static_cast<long long>(b) * S + static_cast<long long>(c) * Q;

  const int n4 = (N + 3) / 4 * 4;
  // 16 loads in flight: no other registers are live yet
  stage<THREADS, T, 16>(Ct, QP, true, cm + row0 * N, N, Q, QM, N, n4);
  stage<THREADS, T, 16>(Rt, QP, true, bm + row0 * N, N, Q, QM, N, n4);
  __syncthreads();
  float cb[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) cb[r][cc] = 0.f;
#pragma unroll 2
  for (int n = 0; n < N; ++n) {
    float cv[8], bv[8];
    load8(&Ct[n * QP + ty * 8], cv);
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) bv[cc] = Rt[n * QP + tx + 16 * cc];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) cb[r][cc] = fmaf(cv[r], bv[cc], cb[r][cc]);
  }

  const int h_end = min(H, (blockIdx.y + 1) * HB3);
  const float* st_c = st + (static_cast<long long>(b) * nc + c) * H * N * P;  // head 0 of the chunk
  bool s0_staged = false;  // the previous pair already sent this pair's first state to S0
  for (int h = blockIdx.y * HB3; h < h_end; h += 2) {
    const bool pair = h + 1 < h_end;
    __syncthreads();  // Bt, or the previous pair's Wt, x and scalars, are consumed
    const float* sin = st_c + static_cast<long long>(h) * N * P;
    if (!s0_staged) stage_f32<THREADS>(S0, PM, sin, P, N, N, P, PM);
    stage_f32<THREADS>(S1, PM, sin + N * P, P, pair ? N : 0, N, P, PM);
    s0_staged = pair && h + 2 < h_end;  // true once this pair's second head prefetches
    for (int idx = tid; idx < 2 * QM; idx += THREADS) {
      const int g = idx / QM, i = idx % QM;
      const bool in = i < Q && (g == 0 || pair);
      cum_s[idx] = in ? cum[(row0 + i) * H + h + g] : 0.f;
      dt_s[idx] = in ? dt[(row0 + i) * H + h + g] : 0.f;
    }
    stage_wait();
    __syncthreads();

    float ya[8][4], yb[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) ya[r][cc] = yb[r][cc] = 0.f;
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      float ct[4], cbm[4], sa[4], sb[4];
      load4(&Ct[n * QP + 4 * ty], ct);
      load4(&Ct[n * QP + 124 - 4 * ty], cbm);
      load4(&S0[n * PM + tx * 4], sa);
      load4(&S1[n * PM + tx * 4], sb);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          ya[r][cc] = fmaf(ct[r], sa[cc], ya[r][cc]);
          yb[r][cc] = fmaf(ct[r], sb[cc], yb[r][cc]);
          ya[r + 4][cc] = fmaf(cbm[r], sa[cc], ya[r + 4][cc]);
          yb[r + 4][cc] = fmaf(cbm[r], sb[cc], yb[r + 4][cc]);
        }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = y_row(ty, r);
      const float ea = expf(cum_s[i]), eb = expf(cum_s[QM + i]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        ya[r][cc] *= ea;
        yb[r][cc] *= eb;
      }
    }

    __syncthreads();  // S0 and S1 are consumed: x of both heads goes there
    const long long xs = static_cast<long long>(H) * P;
    for (int g = 0; g < 2; ++g) {
      const T* xg = x + (row0 * H + h + g) * P;
      float* dst = g == 0 ? S0 : S1;
      const int rows = g == 0 || pair ? Q : 0;
      if constexpr (sizeof(T) == 4)
        stage_f32<THREADS>(dst, PM, reinterpret_cast<const float*>(xg), xs, rows, Q, P, PM);
      else
        stage<THREADS>(dst, PM, false, xg, xs, rows, Q, P, PM);
    }
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      if (g == 1 && !pair) break;
      const float* cg = cum_s + g * QM;
      const float* dg = dt_s + g * QM;
      if (g == 1) {
        __syncthreads();  // the first head's Wt and x are consumed
        if (h + 2 < h_end)  // the next pair's first state goes to S0 under W.x of this head
          stage_f32<THREADS>(S0, PM, st_c + static_cast<long long>(h + 2) * N * P, P, N, N, P,
                             PM);
      }
      // W^T[j][i] for this thread's C.B^T tile. A warp's rows end at
      // wlast; the columns j > wlast are above the diagonal for the whole
      // warp and are never read (add_w_times_x stops at j <= (i | 3)), so the
      // warp skips them: no exp, no store.
      const int wlast = (ty | 1) * 8 + 7;
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        if (16 * cc > wlast) break;
        const int j = tx + 16 * cc;
        if (j >= Q) continue;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int i = ty * 8 + r;
          Rt[j * QP + i] = (j <= i && i < Q) ? cb[r][cc] * __expf(cg[i] - cg[j]) * dg[j] : 0.f;
        }
      }
      if (g == 0) stage_wait();
      __syncthreads();
      float (&acc)[8][4] = g == 0 ? ya : yb;
      add_w_times_x(acc, Rt, g == 0 ? S0 : S1, Q, ty, tx);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = y_row(ty, r);
        if (i < Q && tx * 4 < P)
          store4(y + ((row0 + i) * H + h + g) * P + tx * 4, acc[r], P % 4 == 0, P - tx * 4);
      }
    }
  }
}

size_t state_smem(int Q) { return sizeof(float) * (size_t(Q) * NM + size_t(Q) * PM + QM); }

size_t output_smem(int N, int Q) {
  const size_t nq = max(N, Q);
  return sizeof(float) * (size_t(N) * QP + nq * QP + 2 * nq * PM + 4 * QM);
}

bool bad_shape(int S, int P, int N, int Q) {
  return Q < 1 || Q > QM || P < 1 || P > PM || N < 1 || N > NM || S % Q != 0;
}

template <typename T>
int launch_state(const void* x, const float* dt, const float* cum, const void* bm, float* st,
                 int B, int S, int H, int P, int N, int Q, cudaStream_t stream) {
  const size_t smem = state_smem(Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_state<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_state<T><<<dim3(S / Q, (H + HB1 - 1) / HB1, B), THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, cum, static_cast<const T*>(bm), st, S, H, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_output(const void* x, const float* dt, const float* cum, const void* bm,
                  const void* cm, const float* st, void* y, int B, int S, int H, int P, int N,
                  int Q, cudaStream_t stream) {
  const size_t smem = output_smem(N, Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_output<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_output<T><<<dim3(S / Q, (H + HB3 - 1) / HB3, B), THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, cum, static_cast<const T*>(bm), static_cast<const T*>(cm),
      st, static_cast<T*>(y), S, H, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Layouts of all three entry points: x [B, S, H, P], dt and cum [B, S, H] f32,
// bm and cm [B, S, N], y [B, S, H, P], the state scratch st [B, S/Q, H, N, P]
// f32; all contiguous; chunk Q <= 128 divides S; P <= 64; N <= 128; x, bm,
// cm and y f32. Each returns cudaGetLastError() after its launch (0 on
// success), or the error that refused the shared-memory size.

// st <- each chunk's own state (kernel 1).
extern "C" int ssd_chunk_state(const void* x, const float* dt, const float* cum,
                               const void* bm, float* st, int B, int S, int H, int P, int N,
                               int Q, void* stream) {
  if (bad_shape(S, P, N, Q)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_state<float>(x, dt, cum, bm, st, B, S, H, P, N, Q,
                             static_cast<cudaStream_t>(stream));
}

// st: each chunk's own state -> the state passed into each chunk, in place (kernel 2).
extern "C" int ssd_state_pass(float* st, const float* cum, int B, int S, int H, int P, int N,
                              int Q, void* stream) {
  if (bad_shape(S, P, N, Q)) return static_cast<int>(cudaErrorInvalidValue);
  const int np = N * P;
  ssd_state_pass<<<dim3((np + THREADS - 1) / THREADS, H, B), THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(st, cum, S, H, np, Q);
  return static_cast<int>(cudaGetLastError());
}

// y <- every chunk's output from its inputs and the state passed into it (kernel 3).
extern "C" int ssd_chunk_output(const void* x, const float* dt, const float* cum,
                                const void* bm, const void* cm, const float* st, void* y,
                                int B, int S, int H, int P, int N, int Q, void* stream) {
  if (bad_shape(S, P, N, Q)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_output<float>(x, dt, cum, bm, cm, st, y, B, S, H, P, N, Q,
                              static_cast<cudaStream_t>(stream));
}
