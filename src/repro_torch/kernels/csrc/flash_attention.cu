// Flash attention for Hopper (sm_90a), f32 inputs: causal and sliding-window
// attention with GQA, online softmax, f32 inside, products on the tensor
// cores in 3xTF32 (wgmma). bf16 inputs run csrc/flash_attention_sm90.cu.
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
// 3xTF32. Both products (S = Q.K^T and P.V) run on the tensor cores as TF32
// wgmma with f32 accumulation. Each f32 operand x is split into
// hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi), which keep about 22 of
// its 24 bits, and each product a.b is a_lo.b_hi + a_hi.b_lo + a_hi.b_hi,
// small terms first; a_lo.b_lo (about 2^-22 of a.b) is dropped. This is the
// scheme of CUTLASS's f32-accurate TF32 GEMMs; one TF32 product (hi.hi)
// misses the f32 tolerance (tests/test_torch_attention.py emulates both on
// the CPU). P.V of each k-tile goes into a fresh accumulator that is then
// added to the running output in f32: in trials on the card, one chain of
// tensor-core accumulations over every key lost several times as much.
//
// Design. The TPU grid (B, H, nQ, nK) ran its nK steps in order over one
// output block, with m, l and acc in VMEM scratch. Here one CTA owns one
// (batch, head, 64 or 128-query tile) and walks the k-tiles itself, the
// longest causal rows first: one or two consumer warpgroups of 64 query rows
// and one producer warpgroup. m, l, the score tile and the output live in
// the consumers' wgmma accumulator registers (setmaxnreg moves registers
// from the producer to them).
//  - Staging. Every operand of a TF32 wgmma in shared memory must be K-major,
//    and V, the B operand of P.V, is MN-major in memory (keys are its rows),
//    so no copy engine can feed it. The producer copies each raw K and V tile
//    with cp.async and splits it once for all consumers into a ring of two
//    stages (full and empty mbarriers): K into hi and lo tiles
//    [hd/4][BK][4], V transposed into [BK/4][hd][4]. Each 8-row x 16-byte
//    block is then one wgmma core matrix (no swizzle, every head dim, as in
//    the bf16 kernel). Each consumer splits its 64 scaled query rows once
//    into [hd/4][BQ][4] hi and lo.
//  - The producer splits tile kt + 1 while the consumers compute tile kt.
//    Trials on the card of designs that also overlap a consumer's softmax
//    with products ran no faster: FA3's ping-pong turns between the
//    consumers (slower) and P.V of tile kt - 1 in flight during the softmax
//    of tile kt.
//  - S = Q.K^T: per 8-column k-step three wgmma m64n{BK}k8, both operands
//    from shared memory.
//  - P.V with P in registers. The accumulator of S holds, per lane (g, t),
//    keys 2t and 2t + 1 of each 8-key group; the TF32 A fragment wants
//    columns t and t + 4. The split of V stores each group's keys in the
//    order 0 2 4 6 1 3 5 7, so fragment column t IS key 2t and column t + 4
//    key 2t + 1: the score registers are the A fragments as they stand, with
//    no shuffle and no trip through shared memory. Three wgmma m64n{hd}k8 a
//    k-step.
//  - Skipped tiles: the CTA loads the k-tiles that hold a key one of its
//    queries may see; each warpgroup computes only those its own rows may
//    see; a warpgroup with a row that sees no key (window, more queries than
//    keys) computes every tile, so that row averages V, as the TPU kernel
//    does. Once a row has seen a real score, a fully masked tile gives
//    p = exp(-1e30 - m) = 0 and corr = 1; a fully masked tile before the
//    first real score sets m = -1e30 and p = 1, and the first real score then
//    wipes it with corr = exp(-1e30 - m) = 0, so skipping changes nothing.
//    Keys past T (a ragged last tile) are zeros that score -inf.
//  - GQA reads KV head h / (H / KV) straight from the [B, T, KV, hd] tensor
//    through the strides the wrapper passes: no repeated copy is made.
//  - hd 256 (Gemma-2B) runs a plan of its own (Plan, WIDE): a CTA computes
//    128 of the 256 output dims for 64 queries, so the two CTAs of a query
//    tile both compute S over all 256 dims (1.5 times the products of one
//    CTA a tile), with 16-key tiles that the producer loads into registers
//    and splits straight into the ring (no raw tiles).
//
// Bound. At SmolLM-135M's prefill (B 4, S = T = 2048, H 9, KV 3, hd 64) the
// causal half is 2*B*H*S^2*hd = 19.3 GFLOP of f32 products. On the tensor
// cores that is 3 x 19.3 GFLOP of TF32 at 495 TFLOP/s, 0.117 ms; on the FMA
// pipes (the f32 function's own rate, 67 TFLOP/s) 0.29 ms; q, k, v and o are
// 0.05 GB, 0.015 ms at 3.35 TB/s. The tensor cores idle while a consumer's
// softmax waits for its own products, and the producer's single raw buffer
// exposes one load latency a tile (a second one does not fit beside the
// ring at 64-key tiles, and a trial with the query rows in registers to
// make room ran no faster); this version runs at about 3.5x its bound. At
// Gemma-2B's prefill (B 4, S = T = 2048, H 8, KV 1, hd 256) the causal half
// is 68.7 GFLOP: 3 x 68.7 GFLOP of TF32 is 0.4165 ms, the FMA bound 1.026 ms,
// q, k, v and o 151 MB, 0.045 ms.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

struct Strides {  // element strides of the batch, sequence and head dims
  long long b, s, h;
};

// Tiles per head dim, and the shared-memory plan in floats: the query tile
// (hi, lo), the split K and V tiles (hi, lo) and the raw K and V tiles.
// Stage st's split tiles start at STAGE0 + st * STAGE; within a stage K_HI,
// K_LO, V_HI, V_LO follow each other. The whole plan stays under the 227 KB
// a CTA may use.
//
// hd 256 (WIDE) has a plan of its own. Its split query tile alone is 128 KB
// at 64 rows, and O (128 f32 a thread) beside this tile's P.V (128 more) is
// past the 255 registers a thread may have. So a CTA computes DV = 128 of
// the 256 output dims: two CTAs share a query tile, each with the whole
// S = Q.K^T (all 256 dims) and its own half of V, at 64 + 64 accumulators a
// thread. A stage of 16 keys is then 48 KB (K over 256 dims, V over 128,
// hi and lo), two stages and the query tile 224 KB; there is no room for
// raw tiles, so the producer loads each tile into registers while the
// consumer works on the other stage, then splits it into the free stage.
template <int HD>
struct Plan {
  static constexpr bool WIDE = HD == 256;
  static constexpr int BQ = HD >= 128 ? 64 : 128;  // query rows, 64 a consumer
  static constexpr int BK = WIDE ? 16 : HD >= 80 ? 32 : 64;  // keys a tile
  static constexpr int DV = WIDE ? 128 : HD;  // output dims a CTA computes
  static constexpr int SPLITS = HD / DV;     // CTAs a query tile
  static constexpr int CONSUMERS = BQ / 64;
  static constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer
  static constexpr int STAGES = 2;
  static constexpr int RP = HD + 4;  // raw row pitch: 8 rows of 16-byte loads on 32 banks
  static constexpr int RAW = WIDE ? 0 : BK * RP;  // floats of one raw tile
  static constexpr int Q_HI = 0, Q_LO = BQ * HD;
  static constexpr int STAGE0 = 2 * BQ * HD, STAGE = 2 * BK * HD + 2 * BK * DV;
  static constexpr int K_HI = 0, K_LO = BK * HD, V_HI = 2 * BK * HD, V_LO = 2 * BK * HD + BK * DV;
  static constexpr int K_RAW = STAGE0 + STAGES * STAGE, V_RAW = K_RAW + RAW;
  static constexpr int FLOATS = V_RAW + RAW;
  static constexpr int BYTES = 4 * FLOATS + 8 * 2 * STAGES;  // + the mbarriers
  static_assert(BYTES <= 232448, "shared memory a CTA may use");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// Split four floats and store them as one 16-byte row piece of a hi and a
// lo tile.
__device__ __forceinline__ void split_store(uint32_t* hi, uint32_t* lo, int at, float4 x) {
  uint4 h, l;
  split(x.x, h.x, l.x);
  split(x.y, h.y, l.y);
  split(x.z, h.z, l.z);
  split(x.w, h.w, l.w);
  *reinterpret_cast<uint4*>(hi + at) = h;
  *reinterpret_cast<uint4*>(lo + at) = l;
}

// cp.async of 16 or 4 bytes; an invalid source writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Make this thread's shared-memory stores visible to the tensor cores'
// reads (the async proxy); a barrier then publishes them to the CTA.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Start copying keys k0 .. k0 + BK - 1 of `base` (row stride `stride`) into
// `tile` (row pitch RP); keys >= Tk are zeros. vec: 16-byte copies (a
// 16-byte aligned base and strides that are multiples of 4 floats).
// (by the 128 threads of the producer, ptid its thread)
template <int HD>
__device__ __forceinline__ void load_raw(float* tile, const float* base, long long stride, int k0,
                                         int Tk, bool vec, int ptid) {
  using P = Plan<HD>;
  if (vec) {
    for (int idx = ptid; idx < P::BK * HD / 4; idx += 128) {
      const int j = idx / (HD / 4), c = idx % (HD / 4);
      const bool in = k0 + j < Tk;
      cp_async16(tile + j * P::RP + 4 * c, base + (in ? (k0 + j) * stride : 0) + 4 * c, in);
    }
  } else {
    for (int idx = ptid; idx < P::BK * HD; idx += 128) {
      const int j = idx / HD, d = idx % HD;
      const bool in = k0 + j < Tk;
      cp_async4(tile + j * P::RP + d, base + (in ? (k0 + j) * stride : 0) + d, in);
    }
  }
  asm volatile("cp.async.commit_group;");
}

// Four floats of a row: one 16-byte load (vec) or four 4-byte ones.
__device__ __forceinline__ float4 load4(const float* p, bool vec) {
  return vec ? *reinterpret_cast<const float4*>(p) : make_float4(p[0], p[1], p[2], p[3]);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity) : "memory");
}

// A named barrier of `count` threads.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// Named barrier ids: 0 is __syncthreads; the producer's; each consumer's
// query split.
constexpr int BAR_PRODUCER = 1, BAR_QUERY = 2;

// Registers a thread keeps after setmaxnreg: the producer gives up what its
// copies and splits do not need, the consumers take it (128 * 56 + 256 *
// 224 of the SM's 65536). The producer spilled at 40.
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;

// wgmma shared-memory descriptor, no swizzle: start address, the byte
// distance between core matrices adjacent along K (lbo) and along M/N (sbo).
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void gmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void gmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void gmma_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory"); }

// Keep the compiler from reading or writing accumulators across a wgmma
// boundary it cannot see.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The TF32 wgmma products this kernel issues (scale-d = accumulate): gmma_ss
// for S = Q.K^T with both operands in shared memory, gmma_rs for P.V with P
// in registers; one overload per tile width.
// d[32] (+)= A (shared, K-major) . B (shared, K-major), m64n64k8 tf32
__device__ __forceinline__ void gmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[8] (+)= A (shared, K-major) . B (shared, K-major), m64n16k8 tf32
__device__ __forceinline__ void gmma_ss(float (&d)[8], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[16] (+)= A (shared, K-major) . B (shared, K-major), m64n32k8 tf32
__device__ __forceinline__ void gmma_ss(float (&d)[16], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[16] (+)= A (registers) . B (shared, K-major), m64n32k8 tf32
__device__ __forceinline__ void gmma_rs(float (&d)[16], const uint32_t* a, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d[32] (+)= A (registers) . B (shared, K-major), m64n64k8 tf32
__device__ __forceinline__ void gmma_rs(float (&d)[32], const uint32_t* a, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d[40] (+)= A (registers) . B (shared, K-major), m64n80k8 tf32
__device__ __forceinline__ void gmma_rs(float (&d)[40], const uint32_t* a, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d[64] (+)= A (registers) . B (shared, K-major), m64n128k8 tf32
__device__ __forceinline__ void gmma_rs(float (&d)[64], const uint32_t* a, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// The k-tiles [begin, end) that query rows [first, last] may see; every
// tile when one of those rows sees no key.
template <int BK>
__device__ __forceinline__ void tile_range(int first, int last, int Tk, int window, int causal,
                                           int& begin, int& end) {
  if (window > 0 && last - window + 1 > Tk - 1) {
    begin = 0;
    end = (Tk + BK - 1) / BK;
    return;
  }
  const int lo = window > 0 ? max(0, first - window + 1) : 0;
  const int hi = causal ? min(last, Tk - 1) : Tk - 1;
  begin = lo / BK;
  end = hi / BK + 1;
}

template <int HD>
__global__ void __launch_bounds__(Plan<HD>::THREADS, 1)
flash_fwd_3xtf32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S, int Tk, int group,
                 Strides qs, Strides ks, Strides vs, Strides os, float scale, int window,
                 int causal, int vec) {
  using P = Plan<HD>;
  constexpr int BQ = P::BQ, BK = P::BK, RP = P::RP, CONSUMERS = P::CONSUMERS, DV = P::DV;
  constexpr int STAGES = P::STAGES;
  extern __shared__ __align__(128) float smem[];
  uint32_t* sm = reinterpret_cast<uint32_t*>(smem);
  float* k_raw = smem + P::K_RAW;
  float* v_raw = smem + P::V_RAW;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::FLOATS);
  uint64_t* empty = full + STAGES;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the warpgroup, broadcast so that the compiler knows it is warp-uniform
  // (a wgmma under a branch it cannot prove uniform is serialized)
  const int wg = __shfl_sync(0xffffffffu, warp / 4, 0), wl = warp % 4;
  // the longest causal rows first; d0: the first of the CTA's output dims
  const int qt = gridDim.x / P::SPLITS - 1 - blockIdx.x / P::SPLITS;
  const int d0 = DV * (blockIdx.x % P::SPLITS);
  const int h = blockIdx.y, b = blockIdx.z, q0 = qt * BQ;

  // The CTA's k-tiles, the union of its consumers' ranges, and this
  // consumer's own.
  int cta_begin = 1 << 30, cta_end = 0, my_begin = 0, my_end = 0;
#pragma unroll
  for (int w = 0; w < CONSUMERS; ++w) {
    const int first = q0 + 64 * w, last = min(first + 63, S - 1);
    if (first > last) continue;
    int bgn, end;
    tile_range<BK>(first, last, Tk, window, causal, bgn, end);
    cta_begin = min(cta_begin, bgn);
    cta_end = max(cta_end, end);
    if (w == wg) {
      my_begin = bgn;
      my_end = end;
    }
  }

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 128);             // every producer thread
      mbar_init(&empty[st], CONSUMERS * 4);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {  // the producer: raw tiles in, split tiles out
    if constexpr (CONSUMERS > 1) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    }
    const int ptid = threadIdx.x - 128 * CONSUMERS;
    const float* kb = k + b * ks.b + (h / group) * ks.h;
    const float* vb = v + b * vs.b + (h / group) * vs.h + d0;
    if constexpr (P::WIDE) {
      // tile kt into registers, then into stage st once the consumer frees
      // it: K key j, dims 4c .. 4c + 3 (a warp reads the first 32 bytes of
      // 16 rows); V dim n of the keys of fragment columns 4(kc % 2) .. +3 of
      // the 8-key group kc / 2 (a warp reads 128 bytes of 4 rows)
      constexpr int KN = BK * HD / 4 / 128, VN = BK * DV / 4 / 128;
      for (int kt = cta_begin; kt < cta_end; ++kt) {
        const int i = kt - cta_begin, st = i % STAGES, use = i / STAGES, k0 = kt * BK;
        float4 kr[KN], vr[VN];
#pragma unroll
        for (int r = 0; r < KN; ++r) {
          const int idx = ptid + 128 * r, j = idx % BK, c = idx / BK;
          kr[r] = k0 + j < Tk ? load4(kb + (k0 + j) * ks.s + 4 * c, vec)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int r = 0; r < VN; ++r) {
          const int idx = ptid + 128 * r, n = idx % DV, kc = idx / DV;
          const int j = 8 * (kc / 2) + kc % 2;
          float x[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            x[e] = k0 + j + 2 * e < Tk ? vb[(k0 + j + 2 * e) * vs.s + n] : 0.f;
          vr[r] = make_float4(x[0], x[1], x[2], x[3]);
        }
        if (use > 0) mbar_wait(&empty[st], (use - 1) & 1);
        uint32_t* tile = sm + P::STAGE0 + st * P::STAGE;
#pragma unroll
        for (int r = 0; r < KN; ++r) {
          const int idx = ptid + 128 * r, j = idx % BK, c = idx / BK;
          split_store(tile + P::K_HI, tile + P::K_LO, 4 * (c * BK + j), kr[r]);
        }
#pragma unroll
        for (int r = 0; r < VN; ++r) {
          const int idx = ptid + 128 * r, n = idx % DV, kc = idx / DV;
          split_store(tile + P::V_HI, tile + P::V_LO, 4 * (kc * DV + n), vr[r]);
        }
        fence_proxy_async();
        mbar_arrive(&full[st]);
      }
    } else {  // raw tiles in with cp.async, split tiles out
      if (cta_begin < cta_end) {
        load_raw<HD>(k_raw, kb, ks.s, cta_begin * BK, Tk, vec, ptid);
        load_raw<HD>(v_raw, vb, vs.s, cta_begin * BK, Tk, vec, ptid);
      }
      for (int kt = cta_begin; kt < cta_end; ++kt) {
        const int i = kt - cta_begin, st = i % STAGES, use = i / STAGES;
        uint32_t* tile = sm + P::STAGE0 + st * P::STAGE;
        cp_async_wait_all();
        named_sync(BAR_PRODUCER, 128);  // raw K, V of tile kt are in
        if (use > 0) mbar_wait(&empty[st], (use - 1) & 1);
        for (int idx = ptid; idx < BK * HD / 4; idx += 128) {
          const int j = idx % BK, c = idx / BK;  // K: key j, dims 4c .. 4c + 3
          split_store(tile + P::K_HI, tile + P::K_LO, 4 * (c * BK + j),
                      *reinterpret_cast<const float4*>(k_raw + j * RP + 4 * c));
        }
        for (int idx = ptid; idx < BK * HD / 4; idx += 128) {
          // V^T: dim n, the keys of fragment columns 4(kc % 2) .. +3 of the
          // 8-key group kc / 2, stored as keys 0 2 4 6 | 1 3 5 7 of the group
          const int n = idx % HD, kc = idx / HD;
          const float* col = v_raw + (8 * (kc / 2) + kc % 2) * RP + n;
          split_store(tile + P::V_HI, tile + P::V_LO, 4 * (kc * HD + n),
                      make_float4(col[0], col[2 * RP], col[4 * RP], col[6 * RP]));
        }
        fence_proxy_async();
        mbar_arrive(&full[st]);
        named_sync(BAR_PRODUCER, 128);  // the raw tiles are free
        if (kt + 1 < cta_end) {
          load_raw<HD>(k_raw, kb, ks.s, (kt + 1) * BK, Tk, vec, ptid);
          load_raw<HD>(v_raw, vb, vs.s, (kt + 1) * BK, Tk, vec, ptid);
        }
      }
    }
    return;
  }

  // consumer wg: query rows q0 + 64 wg + [0, 64)
  if constexpr (CONSUMERS > 1) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  }
  const int first = q0 + 64 * wg;
  const float* qb = q + b * qs.b + h * qs.h;
  for (int idx = threadIdx.x % 128; idx < 64 * HD / 4; idx += 128) {
    const int i = idx % 64, c = idx / 64;  // the scaled rows, split into [hd/4][BQ][4]
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (first + i < S) {
      const float* row = qb + (first + i) * qs.s + 4 * c;
      x = make_float4(row[0] * scale, row[1] * scale, row[2] * scale, row[3] * scale);
    }
    split_store(sm + P::Q_HI, sm + P::Q_LO, 4 * (c * BQ + 64 * wg + i), x);
  }
  fence_proxy_async();
  named_sync(BAR_QUERY + wg, 128);

  const int row_a = first + 16 * wl + lane / 4, row_b = row_a + 8;
  const int col0 = 2 * (lane % 4);
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;
  float acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;

  // Q: this consumer's 64 rows of [hd/4][BQ][4]: core matrices 128 B apart
  // along M, BQ*16 B apart along K. K: [hd/4][BK][4], likewise. V^T:
  // [BK/4][DV][4], 128 B apart along N, DV*16 B along K (keys).
  const uint64_t dq_hi = gmma_desc(sm + P::Q_HI + 64 * wg * 4, BQ * 16, 128);
  const uint64_t dq_lo = gmma_desc(sm + P::Q_LO + 64 * wg * 4, BQ * 16, 128);
  const uint64_t dk_hi = gmma_desc(sm + P::STAGE0 + P::K_HI, BK * 16, 128);
  const uint64_t dk_lo = gmma_desc(sm + P::STAGE0 + P::K_LO, BK * 16, 128);
  const uint64_t dv_hi = gmma_desc(sm + P::STAGE0 + P::V_HI, DV * 16, 128);
  const uint64_t dv_lo = gmma_desc(sm + P::STAGE0 + P::V_LO, DV * 16, 128);
  constexpr uint64_t STAGE_STEP = (P::STAGE * 4) >> 4;  // a stage in descriptor units

  const int last = min(first + 63, S - 1);
  for (int kt = cta_begin; kt < cta_end; ++kt) {
    const int i = kt - cta_begin, st = i % STAGES;
    mbar_wait(&full[st], (i / STAGES) & 1);
    if (kt >= my_begin && kt < my_end) {  // a row of this consumer sees tile kt
      const uint64_t so = st * STAGE_STEP;
      const int k0 = kt * BK;
      float s[BK / 2];
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) s[j] = 0.f;
      fence_regs(s);
      gmma_fence();
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) {  // dims 8c .. 8c + 7
        const uint64_t oq = (c * 2 * BQ * 16) >> 4, ok = so + ((c * 2 * BK * 16) >> 4);
        gmma_ss(s, dq_lo + oq, dk_hi + ok, c > 0);
        gmma_ss(s, dq_hi + oq, dk_lo + ok, 1);
        gmma_ss(s, dq_hi + oq, dk_hi + ok, 1);
      }
      gmma_commit();
      gmma_wait();
      fence_regs(s);

      const bool need_mask = k0 + BK > Tk || (causal && k0 + BK - 1 > first) ||
                             (window > 0 && k0 <= last - window);
      float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        if (need_mask) {
          const int col = k0 + 8 * (j / 4) + col0 + (j & 1);
          const int row = (j & 2) ? row_b : row_a;
          if (col >= Tk) {
            s[j] = __int_as_float(0xff800000);  // -inf: past the keys, weighs nothing
          } else if ((causal && col > row) || (window > 0 && col <= row - window)) {
            s[j] = NEG_INF;
          }
        }
        if (j & 2) mx_b = fmaxf(mx_b, s[j]); else mx_a = fmaxf(mx_a, s[j]);
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {  // the four lanes of a row
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float corr_a = expf(m_a - mn_a), corr_b = expf(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
      // p, split into the A fragments of P.V: k-step kk takes s[4kk + 0, 2, 1, 3]
      uint32_t p_hi[BK / 2], p_lo[BK / 2];
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const float p = expf(s[j] - ((j & 2) ? mn_b : mn_a));
        if (j & 2) sum_b += p; else sum_a += p;
        const int at = (j & ~3) | ((j & 1) << 1) | ((j & 2) >> 1);
        split(p, p_hi[at], p_lo[at]);
      }
      l_a = l_a * corr_a + sum_a;
      l_b = l_b * corr_b + sum_b;

      float pv[DV / 2];  // this tile's P.V, added to acc in f32
#pragma unroll
      for (int j = 0; j < DV / 2; ++j) pv[j] = 0.f;
      fence_regs(pv);
      gmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {  // keys 8kk .. 8kk + 7
        const uint64_t ov = so + ((kk * 2 * DV * 16) >> 4);
        gmma_rs(pv, p_lo + 4 * kk, dv_hi + ov, kk > 0);
        gmma_rs(pv, p_hi + 4 * kk, dv_lo + ov, 1);
        gmma_rs(pv, p_hi + 4 * kk, dv_hi + ov, 1);
      }
      gmma_commit();
      gmma_wait();
      fence_regs(pv);
#pragma unroll
      for (int j = 0; j < DV / 2; ++j) acc[j] = fmaf(acc[j], (j & 2) ? corr_b : corr_a, pv[j]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with the stage
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  float* ob = o + b * os.b + h * os.h + d0;
#pragma unroll
  for (int j = 0; j < DV / 2; j += 2) {
    const int col = 8 * (j / 4) + col0;
    const int row = (j & 2) ? row_b : row_a;
    const float den = (j & 2) ? den_b : den_a;
    if (row < S)
      *reinterpret_cast<float2*>(ob + row * os.s + col) = make_float2(acc[j] / den, acc[j + 1] / den);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int Tk,
           int H, int KV, Strides qs, Strides ks, Strides vs, Strides os, float scale,
           int window, int causal, int vec, cudaStream_t stream) {
  using P = Plan<HD>;
  constexpr int smem = P::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_3xtf32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + P::BQ - 1) / P::BQ * P::SPLITS, H, B);
  flash_fwd_3xtf32<HD><<<grid, P::THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), S, Tk, H / KV, qs, ks, vs, os, scale, window, causal, vec);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p, const Strides& st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % 4 == 0 && st.s % 4 == 0 &&
         st.h % 4 == 0;
}

}  // namespace

// f32 q [B, S, H, hd], k/v [B, T, KV, hd], o [B, S, H, hd], each with unit
// stride over hd and the given element strides over batch, sequence and
// head; hd in {32, 64, 80, 128, 256}; scale = hd^-0.5 rounded to f32 by the caller.
// o must have an 8-byte aligned base and even strides (the wrapper allocates
// it); k and v are copied 16 bytes at a time where they have a 16-byte
// aligned base and strides of a multiple of 4, 4 bytes otherwise. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                               int S, int Tk, int H, int KV, int hd, long long q_sb,
                               long long q_ss, long long q_sh, long long k_sb, long long k_ss,
                               long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                               long long o_sb, long long o_ss, long long o_sh, float scale,
                               int window, int causal, void* stream) {
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh};
  if (reinterpret_cast<uintptr_t>(o) % 8 || o_sb % 2 || o_ss % 2 || o_sh % 2)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int vec = aligned16(k, ks) && aligned16(v, vs);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch<32>(q, k, v, o, B, S, Tk, H, KV, qs, ks, vs, os, scale, window, causal, vec, st);
    case 64: return launch<64>(q, k, v, o, B, S, Tk, H, KV, qs, ks, vs, os, scale, window, causal, vec, st);
    case 80: return launch<80>(q, k, v, o, B, S, Tk, H, KV, qs, ks, vs, os, scale, window, causal, vec, st);
    case 128: return launch<128>(q, k, v, o, B, S, Tk, H, KV, qs, ks, vs, os, scale, window, causal, vec, st);
    case 256: return launch<256>(q, k, v, o, B, S, Tk, H, KV, qs, ks, vs, os, scale, window, causal, vec, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
