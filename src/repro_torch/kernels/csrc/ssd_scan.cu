// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan_chunked
// (_ssd_kernel); the plain version is src/repro_torch/kernels/ref.py::
// ssd_scan_chunked_ref. The model calls it from src/repro_torch/models/
// ssm.py::apply_ssm under use_kernel.
//
// What it computes, per (batch, head), chunk by chunk, in f32 (cum is the
// within-chunk cumulative sum of dt*A, computed by the wrapper as the TPU
// wrapper does):
//   y_i    = sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) dt_j x_j + exp(cum_i) C_i.state
//   state <- exp(cum_last) state + sum_j exp(cum_last - cum_j) dt_j B_j (x) x_j
// with the f32 state [N, P] carried from chunk to chunk. The TPU kernel's
// a_head input is never read in its body, so this kernel does not take it.
//
// Design. The TPU grid (B, head blocks, chunks) ran its chunk steps in order
// with the state in VMEM scratch: the sequential grid was the recurrence.
// Here one thread block owns one (batch, head) and loops over the chunks
// itself, with the state [N, P] in shared memory for the whole sequence
// (32 KB at N 128, P 64). Per chunk: x [Q, P], dt, cum and
// exp(cum_last - cum_j) dt_j are staged in shared memory; B and C are read in
// tiles of 32 state channels, transposed to [32][Q]; each tile feeds the
// C.B^T product (registers, 8x8 per thread), the inter-chunk product C.state
// (registers, 8x4 per thread) and then the state update of the tile's 32
// rows. The decay-weighted lower triangle W goes to shared memory and the
// intra-chunk product W.x finishes the chunk. exp(cum_i - cum_j) is taken
// only for j <= i: above the diagonal it can overflow to inf, and inf * 0 is
// NaN. Shared memory at N 128: 164 KB of the 227 KB a block may take. Chunk
// lengths up to 128 and head dims up to 64 are zero-padded to 128 x 64.
//
// Bound. Per (batch, chunk) the function needs the lower triangle of C.B^T
// (Q(Q+1)N operations) and per head the lower-triangular W.x (Q(Q+1)P), the
// inter-chunk product and the state update (2QNP each). At Mamba2-370M's
// prefill (B 4, S 2048, H 32, P 64, N 128, Q 128) that is 10.9 GFLOP: 0.16 ms
// at the 67 TFLOP/s of f32 FMA, against 0.04 ms for the 0.15 GB of x, y, dt,
// cum, B and C at 3.35 TB/s. This kernel does more: it computes the whole
// C.B^T square, once per head. It is an operation-bound function, and this
// kernel runs it on 128 blocks (B x H) for
// 132 SMs, one block per SM, each with the whole recurrence of its head: the
// chunk-parallel form (intra-chunk outputs and per-chunk states for all
// chunks at once, then a short pass over the states) is the redesign
// (ROADMAP Queue 2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int QM = 128;       // largest chunk
constexpr int PM = 64;        // largest head dim
constexpr int NT = 32;        // state channels per B/C tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int WP = QM + 4;    // padded row of Wt (keeps 16-byte alignment)
constexpr int TP = QM + 1;    // padded row of the B/C tiles (conflict-free transpose)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

size_t smem_floats(int n) { return size_t(n) * PM + QM * PM + QM * WP + 2 * NT * TP + 3 * QM; }

// x [B, S, H, P], dt and cum [B, S, H] f32, bm and cm [B, S, N], y [B, S, H, P];
// x, bm, cm and y of type T; all contiguous; S % Q == 0.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ cum, const T* __restrict__ bm,
                const T* __restrict__ cm, T* __restrict__ y, int S, int H, int P, int N,
                int Q) {
  extern __shared__ float smem[];
  float* state = smem;              // [N][PM]
  float* xs = state + N * PM;       // [QM][PM]
  float* Wt = xs + QM * PM;         // [QM][WP], Wt[j][i] = W[i][j]
  float* Bt = Wt + QM * WP;         // [NT][TP]
  float* Ct = Bt + NT * TP;         // [NT][TP]
  float* cum_s = Ct + NT * TP;      // [QM]
  float* dt_s = cum_s + QM;         // [QM]
  float* sd_s = dt_s + QM;          // [QM]: exp(cum_last - cum_j) dt_j

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const int nc = S / Q;

  for (int idx = tid; idx < N * PM; idx += THREADS) state[idx] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const long long row0 = static_cast<long long>(b) * S + static_cast<long long>(c) * Q;
    __syncthreads();  // the previous chunk is done with xs, Wt and the scalars
    for (int idx = tid; idx < QM * PM; idx += THREADS) {
      const int j = idx / PM, p = idx % PM;
      xs[idx] = (j < Q && p < P) ? to_f32(x[((row0 + j) * H + h) * P + p]) : 0.f;
    }
    for (int j = tid; j < QM; j += THREADS) {
      const bool in = j < Q;
      cum_s[j] = in ? cum[(row0 + j) * H + h] : 0.f;
      dt_s[j] = in ? dt[(row0 + j) * H + h] : 0.f;
    }
    __syncthreads();
    const float cum_last = cum_s[Q - 1];
    for (int j = tid; j < QM; j += THREADS)
      sd_s[j] = j < Q ? expf(cum_last - cum_s[j]) * dt_s[j] : 0.f;
    const float lam = expf(cum_last);

    float cb[8][8], yi[8][4];  // rows i = 8ty + r; cols j = tx + 16c / p = tx + 16c
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) cb[r][cc] = 0.f;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) yi[r][cc] = 0.f;
    }

    for (int n0 = 0; n0 < N; n0 += NT) {
      const int nt = min(NT, N - n0);
      __syncthreads();  // the previous tile's B, C and state rows are consumed
      for (int idx = tid; idx < QM * NT; idx += THREADS) {
        const int j = idx / NT, nn = idx % NT;  // coalesced along n in memory
        const bool in = j < Q && nn < nt;
        const long long at = (row0 + j) * N + n0 + nn;
        Bt[nn * TP + j] = in ? to_f32(bm[at]) : 0.f;
        Ct[nn * TP + j] = in ? to_f32(cm[at]) : 0.f;
      }
      __syncthreads();
      for (int nn = 0; nn < nt; ++nn) {
        float cv[8], bv[8], sv[4];
#pragma unroll
        for (int r = 0; r < 8; ++r) cv[r] = Ct[nn * TP + ty * 8 + r];
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) bv[cc] = Bt[nn * TP + tx + 16 * cc];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) sv[cc] = state[(n0 + nn) * PM + tx + 16 * cc];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
#pragma unroll
          for (int cc = 0; cc < 8; ++cc) cb[r][cc] = fmaf(cv[r], bv[cc], cb[r][cc]);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) yi[r][cc] = fmaf(cv[r], sv[cc], yi[r][cc]);
        }
      }
      __syncthreads();  // every read of this tile's state rows is done
      // state rows n0 + 2ty, n0 + 2ty + 1; columns p = tx + 16c
      const int n_a = ty * 2, n_b = ty * 2 + 1;
      float ua[4] = {0.f, 0.f, 0.f, 0.f}, ub[4] = {0.f, 0.f, 0.f, 0.f};
      for (int j = 0; j < Q; ++j) {
        const float wa = Bt[n_a * TP + j] * sd_s[j], wb = Bt[n_b * TP + j] * sd_s[j];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float xv = xs[j * PM + tx + 16 * cc];
          ua[cc] = fmaf(wa, xv, ua[cc]);
          ub[cc] = fmaf(wb, xv, ub[cc]);
        }
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int p = tx + 16 * cc;
        if (n_a < nt) state[(n0 + n_a) * PM + p] = lam * state[(n0 + n_a) * PM + p] + ua[cc];
        if (n_b < nt) state[(n0 + n_b) * PM + p] = lam * state[(n0 + n_b) * PM + p] + ub[cc];
      }
    }

    // W[i][j] = (C_i.B_j) exp(cum_i - cum_j) dt_j for j <= i, stored transposed
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty * 8 + r;
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const int j = tx + 16 * cc;
        Wt[j * WP + i] = (j <= i && i < Q) ? cb[r][cc] * expf(cum_s[i] - cum_s[j]) * dt_s[j]
                                           : 0.f;
      }
    }
    __syncthreads();

    float ya[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) ya[r][cc] = 0.f;
    const int jmax = min(Q, ty * 8 + 8);  // W is zero above the diagonal
    for (int j = 0; j < jmax; ++j) {
      const float4 w0 = *reinterpret_cast<const float4*>(&Wt[j * WP + ty * 8]);
      const float4 w1 = *reinterpret_cast<const float4*>(&Wt[j * WP + ty * 8 + 4]);
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      float xv[4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) xv[cc] = xs[j * PM + tx + 16 * cc];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) ya[r][cc] = fmaf(wv[r], xv[cc], ya[r][cc]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty * 8 + r;
      if (i >= Q) continue;
      const float ec = expf(cum_s[i]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int p = tx + 16 * cc;
        if (p < P) y[((row0 + i) * H + h) * P + p] = from_f32<T>(ya[r][cc] + yi[r][cc] * ec);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* cum, const void* bm, const void* cm,
           void* y, int B, int S, int H, int P, int N, int Q, cudaStream_t stream) {
  const size_t smem = smem_floats(N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<T><<<dim3(H, B), THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, cum, static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<T*>(y), S, H, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [B, S, H, P], dt and cum [B, S, H] f32, bm and cm [B, S, N], y [B, S, H, P],
// all contiguous; chunk Q <= 128 divides S; P <= 64; N such that the shared
// memory fits (N <= 381). dtype of x, bm, cm and y alike: 0 f32, 1 bf16.
// Returns cudaGetLastError() after the launch (0 on success), or the error
// that refused the shared-memory size.
extern "C" int ssd_scan(const void* x, const float* dt, const float* cum, const void* bm,
                        const void* cm, void* y, int B, int S, int H, int P, int N, int Q,
                        int dtype, void* stream) {
  if (Q < 1 || Q > QM || P < 1 || P > PM || S % Q != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, dt, cum, bm, cm, y, B, S, H, P, N, Q, st);
    case 1: return launch<__nv_bfloat16>(x, dt, cum, bm, cm, y, B, S, H, P, N, Q, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
