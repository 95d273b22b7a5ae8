// Flash attention for Hopper (sm_90a), f32 inputs: causal and sliding-window
// attention with GQA, online softmax, f32 inside. bf16 inputs run the tensor
// core kernel of csrc/flash_attention_sm90.cu.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_bhsd (_flash_kernel); the plain version is
// src/repro_torch/kernels/ref.py::flash_attention_ref. The model calls it from
// src/repro_torch/models/attention.py::attend_full under use_kernel.
//
// What it computes, as the TPU kernel: q is scaled by hd^-0.5, scores
// s = q.k in f32; a key j is masked for query i when j > i
// (causal) or j <= i - window (window > 0, applied with or without causal);
// masked scores are -1e30; per k-tile m_new = max(m, rowmax(s)),
// p = exp(s - m_new), corr = exp(m - m_new), l = l*corr + sum(p),
// acc = acc*corr + p.v; out = acc / max(l, 1e-30).
//
// Design. The TPU grid (B, H, nQ, nK) ran its nK steps in order over one
// output block, with m, l and acc in VMEM scratch. Here one thread block owns
// one (batch, head, 64-query tile) and walks the k-tiles itself: K and V
// tiles of 64 rows are staged in shared memory as f32, the query tile stays
// in shared memory, the 64x64 score tile goes through shared memory on its
// way from the score layout to the P.V layout, and m, l and acc live in
// registers (thread (ty, tx) of 16x16 owns rows 4ty..4ty+3; the 16 lanes of a
// row reduce its max and sum with warp shuffles). GQA reads KV head
// h / (H / KV) straight from the [B, T, KV, hd] tensor through the strides
// the wrapper passes: no repeated or transposed copy is made.
//
// Skipped tiles. The TPU kernel computes every k-tile. This kernel computes
// only the tiles that hold a key some query of its tile may see: those above
// the diagonal (causal) and left of the window are skipped. The result is the
// same: once a row has seen a real score, a fully masked tile gives p =
// exp(-1e30 - m) = 0 and corr = 1; a fully masked tile before the first real
// score sets m = -1e30 and p = 1, and the first real score then wipes it with
// corr = exp(-1e30 - m) = 0. Only a row that sees no key at all (window with
// more queries than keys) depends on the masked tiles: its output is the mean
// of V. A block holding such a row computes every tile, as the TPU kernel
// does. Keys past T (a ragged last tile) score -inf and weigh nothing.
//
// Bound. f32 inputs make it an f32 function: the FMA pipes (67 TFLOP/s on an
// H100 SXM), not the tensor cores, bound it. At SmolLM-135M's prefill (B 4,
// S = T = 2048, H 9, KV 3, hd 64) the causal half is 2*B*H*S^2*hd = 19.3
// GFLOP, 0.29 ms; q, k, v and o are 0.15 GB, 0.045 ms at 3.35 TB/s. f32 FMA
// on purpose: TF32 mma.sync would break the 2e-5 tolerance against the plain
// version. The inner products read both operands from shared memory (two
// loads per four FMAs in the score loop), so this simple version is expected
// to run well below the FMA rate; 3xTF32 on the tensor cores or a larger FMA
// micro-tile is its redesign (ROADMAP Queue 2).
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;         // queries per block
constexpr int BK = 64;         // keys per k-tile
constexpr int THREADS = 256;   // 16 x 16
constexpr float NEG_INF = -1e30f;

struct Strides {  // element strides of the batch, sequence and head dims
  long long b, s, h;
};

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1));
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          float* __restrict__ o, int S, int Tk, int group, Strides qs, Strides ks, Strides vs,
          Strides os, float scale, int window, int causal) {
  constexpr int HP = HD + 1;   // padded rows: a column walk hits 32 banks
  constexpr int PP = BK + 1;
  constexpr int NC = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][HP], scaled
  float* Ks = Qs + BQ * HP;     // [BK][HP]
  float* Vs = Ks + BK * HP;     // [BK][HD]
  float* Ps = Vs + BK * HD;     // [BQ][PP]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + (h / group) * ks.h;
  const float* vb = v + b * vs.b + (h / group) * vs.h;

  for (int idx = tid; idx < BQ * HD; idx += THREADS) {
    const int i = idx / HD, d = idx % HD;
    Qs[i * HP + d] = q0 + i < S ? qb[(q0 + i) * qs.s + d] * scale : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  // The k-tiles that hold a key some query of this tile may see.
  const int q_last = min(q0 + BQ, S) - 1;
  int kt_begin = 0, kt_end = (Tk + BK - 1) / BK;
  if (!(window > 0 && q_last - window + 1 > Tk - 1)) {  // every row sees a key
    const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
    const int hi = causal ? min(q_last, Tk - 1) : Tk - 1;
    kt_begin = lo / BK;
    kt_end = hi / BK + 1;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int idx = tid; idx < BK * HD; idx += THREADS) {
      const int j = idx / HD, d = idx % HD;
      const bool in = k0 + j < Tk;
      Ks[j * HP + d] = in ? kb[(k0 + j) * ks.s + d] : 0.f;
      Vs[j * HD + d] = in ? vb[(k0 + j) * vs.s + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = Qs[(ty * 4 + r) * HP + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = Ks[(tx + 16 * c) * HP + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q0 + ty * 4 + r;
      float rmax = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx + 16 * c;
        if (kpos >= Tk) {
          s[r][c] = __int_as_float(0xff800000);  // -inf
        } else if ((causal && kpos > qpos) || (window > 0 && kpos <= qpos - window)) {
          s[r][c] = NEG_INF;
        }
        rmax = fmaxf(rmax, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)  // the row's 16 lanes
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[r], rmax);
      const float corr = expf(m[r] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[r][c] - m_new);
        Ps[(ty * 4 + r) * PP + tx + 16 * c] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[r] = l[r] * corr + rsum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[4], vv[NC];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = Ps[(ty * 4 + r) * PP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = Vs[j * HD + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(pv[r], vv[c], acc[r][c]);
    }
  }

  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty * 4 + r;
    if (i >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) ob[i * os.s + tx + 16 * c] = acc[r][c] / denom;
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int Tk,
           int H, int KV, Strides qs, Strides ks, Strides vs, Strides os, float scale,
           int window, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), S, Tk, H / KV, qs, ks, vs, os, scale, window, causal);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o, int B, int S,
                int Tk, int H, int KV, Strides qs, Strides ks, Strides vs, Strides os,
                float scale, int window, int causal, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<32>(q, k, v, o, B, S, Tk, H, KV, qs, ks, vs, os, scale, window, causal, stream);
    case 64: return launch<64>(q, k, v, o, B, S, Tk, H, KV, qs, ks, vs, os, scale, window, causal, stream);
    case 80: return launch<80>(q, k, v, o, B, S, Tk, H, KV, qs, ks, vs, os, scale, window, causal, stream);
    case 128: return launch<128>(q, k, v, o, B, S, Tk, H, KV, qs, ks, vs, os, scale, window, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// f32 q [B, S, H, hd], k/v [B, T, KV, hd], o [B, S, H, hd], each with unit
// stride over hd and the given element strides over batch, sequence and
// head; hd in {32, 64, 80, 128}; scale = hd^-0.5 rounded to f32 by the caller.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                               int S, int Tk, int H, int KV, int hd, long long q_sb,
                               long long q_ss, long long q_sh, long long k_sb, long long k_ss,
                               long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                               long long o_sb, long long o_ss, long long o_sh, float scale,
                               int window, int causal, void* stream) {
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh};
  return dispatch_hd(hd, q, k, v, o, B, S, Tk, H, KV, qs, ks, vs, os, scale, window, causal,
                     static_cast<cudaStream_t>(stream));
}
