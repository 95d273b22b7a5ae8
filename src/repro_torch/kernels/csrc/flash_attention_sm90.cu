// Flash attention for Hopper (sm_90a), bf16 on the tensor cores: causal and
// sliding-window attention with GQA, online softmax in f32.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_bhsd (_flash_kernel) for bf16 inputs; the f32 inputs run
// csrc/flash_attention.cu. The plain version is src/repro_torch/kernels/
// ref.py::flash_attention_ref. The model calls it from src/repro_torch/models/
// attention.py::attend_full under use_kernel.
//
// What it computes, as the TPU kernel: scores s = q.k * hd^-0.5 in f32; a key
// j is masked for query i when j > i (causal) or j <= i - window (window > 0,
// applied with or without causal); masked scores are -1e30; per k-tile
// m_new = max(m, rowmax(s)), p = exp(s - m_new), corr = exp(m - m_new),
// l = l*corr + sum(p), acc = acc*corr + p.v; out = acc / max(l, 1e-30) in
// bf16. Two differences from the f32 kernel, both on purpose: hd^-0.5 scales
// the f32 scores after the product (bf16 q cannot be scaled in f32 before it;
// exact where hd^-0.5 is a power of two, hd 64), and p is rounded to bf16 as
// the A operand of P.V, as SDPA does (the plain version keeps it f32). The
// softmax runs in base 2 with log2(e) folded into the scale.
//
// Design. One CTA owns one (batch, head, 128-query tile): two consumer
// warpgroups of 64 query rows each and one producer warp (288 threads); at
// hd 256 a producer warpgroup and two stages (see Cfg).
//  - The producer's first lane issues TMA loads (cp.async.bulk.tensor, 4-d
//    maps over [B, S, H, hd] with the tensors' own strides, so KV head
//    h / (H / KV) is read in place): the query tile once, then the K and V
//    tiles of 64 keys into a ring of 3 stages, each with a full and an empty
//    mbarrier. The maps are encoded on the host per call through
//    cuTensorMapEncodeTiled, reached with cudaGetDriverEntryPoint so that
//    the library links only the runtime.
//  - Shared-memory layout, no swizzle for every head dim: a tile of R rows is
//    stored as hd/8 column blocks [hd/8][R][8], each 16-byte row piece of 8
//    elements one TMA box {8, 1, R, 1}. Every 8x8 block is then one 128-byte
//    wgmma core matrix, so hd 80 (160-byte rows) and hd 32 (64-byte rows),
//    which do not fill a 128-byte swizzle atom, need no padding.
//  - S = Q.K^T: wgmma m64n64k16, Q and K both K-major from shared memory,
//    f32 accumulators in registers (32 a thread).
//  - Online softmax in the accumulator's layout: a thread holds two rows
//    (lane/4 and lane/4 + 8 of its warp's 16) and 16 columns of each; a row's
//    max reduces over the four lanes that share it; l stays per thread and
//    is reduced once at the end.
//  - O += P.V: wgmma m64n{hd}k16 (at hd 256 the widest, m64n256k16, 128
//    accumulators a thread) with P converted to bf16 in registers as
//    the A operand (the accumulator layout of S is the A-fragment layout of
//    P) and V MN-major from shared memory; O f32 in registers.
//  - Skipped tiles: the CTA loads the k-tiles that hold a key one of its
//    queries may see, and each warpgroup computes only those its own rows
//    may see; a warpgroup with a row that sees no key (window, more queries
//    than keys) computes every tile, so that row averages V, as the TPU
//    kernel does. The f32 kernel's source shows why skipping a fully masked
//    tile changes nothing for the other rows.
//
// Bound. At SmolLM-135M's prefill (B 4, S = T = 2048, H 9, KV 3, hd 64) the
// causal half of Q.K^T and P.V is 2*B*H*S^2*hd = 19.3 GFLOP: 0.0195 ms at
// 989 TFLOP/s of dense bf16; q, k, v and o are 38 MB, 0.011 ms at 3.35 TB/s.
// It is bound by the tensor cores. At Gemma-2B's (B 4, S = T = 2048, H 8,
// KV 1, hd 256) it is 68.7 GFLOP, 0.0695 ms; 75.5 MB, 0.0225 ms. This first
// version does not overlap one warpgroup's softmax with its own products (the
// two warpgroups overlap each other) and stores O straight from registers.
#include <cuda.h>  // CUtensorMap and its enums (types only; libcuda is not linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;                       // queries per CTA
constexpr int BK = 64;                        // keys per k-tile
constexpr int CONSUMERS = 2;                  // warpgroups of 64 query rows
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// The K/V ring's depth and the producer's width per head dim. Up to hd 128:
// three stages and one producer warp (288 threads). hd 256: the query tile
// (64 KB) and three stages (64 KB each) would pass the 227 KB a CTA may use,
// so two stages (192 KB); and a consumer thread holds O (128 f32) beside S
// (32), more than the 224 registers an even split of 288 threads leaves with
// the rest of its state, so the producer is a whole warpgroup (384 threads)
// that gives registers to the consumers with setmaxnreg.
template <int HD>
struct Cfg {
  static constexpr bool WIDE = HD == 256;
  static constexpr int STAGES = WIDE ? 2 : 3;
  static constexpr int THREADS = 128 * CONSUMERS + (WIDE ? 128 : 32);
};
// setmaxnreg at hd 256: 128 * 40 + 256 * 232 = 384 * 168, the registers the
// CTA is launched with.
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

template <int HD>
struct alignas(128) Smem {
  static constexpr int STAGES = Cfg<HD>::STAGES;
  __nv_bfloat16 q[BQ * HD];          // [HD/8][BQ][8]
  __nv_bfloat16 k[STAGES][BK * HD];  // [HD/8][BK][8]
  __nv_bfloat16 v[STAGES][BK * HD];
  uint64_t q_full, full[STAGES], empty[STAGES];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity) : "memory");
}

// One box of a 4-d tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3) : "memory");
}

// wgmma shared-memory descriptor, no swizzle: start address, the byte
// distance between core matrices adjacent along K (lbo) and along M/N (sbo).
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void gmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void gmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void gmma_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keep the compiler from reading or writing accumulators across a wgmma
// boundary it cannot see.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The wgmma products this kernel issues. gmma_ss: S = Q.K^T, both operands
// K-major in shared memory. gmma_rs: O += P.V, P in registers, V MN-major
// in shared memory (imm-trans-b 1); one overload per head dim.
// d[32] += A (shared, K-major) . B (shared, K-major), m64n64k16
__device__ __forceinline__ void gmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[16] += A (registers) . B (shared, MN-major), m64n32k16
__device__ __forceinline__ void gmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[32] += A (registers) . B (shared, MN-major), m64n64k16
__device__ __forceinline__ void gmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[40] += A (registers) . B (shared, MN-major), m64n80k16
__device__ __forceinline__ void gmma_rs(float (&d)[40], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64] += A (registers) . B (shared, MN-major), m64n128k16
__device__ __forceinline__ void gmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[128] += A (registers) . B (shared, MN-major), m64n256k16
__device__ __forceinline__ void gmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

struct Strides {  // element strides of the batch, sequence and head dims
  long long b, s, h;
};

// The k-tiles [begin, end) that query rows [first, last] may see, and
// whether one of those rows sees no key (then every tile counts).
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
__global__ void __launch_bounds__(Cfg<HD>::THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o, int S,
                int Tk, int group, Strides os, float scale_log2, int window, int causal) {
  static_assert(HD % 16 == 0 && HD <= 256, "head dim");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<HD>& sm = *reinterpret_cast<Smem<HD>*>(smem_raw);
  constexpr int STAGES = Cfg<HD>::STAGES;

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z, q0 = qt * BQ;
  // the warp, broadcast so that the compiler knows it is warp-uniform (the
  // warpgroup branches below hold setmaxnreg and wgmma)
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0), lane = threadIdx.x % 32;

  // The CTA's k-tiles: the union of its warpgroups' ranges.
  int cta_begin = 1 << 30, cta_end = 0;
#pragma unroll
  for (int w = 0; w < CONSUMERS; ++w) {
    const int first = q0 + 64 * w, last = min(first + 63, S - 1);
    if (first > last) continue;
    int bgn, end;
    tile_range(first, last, Tk, window, causal, bgn, end);
    cta_begin = min(cta_begin, bgn);
    cta_end = max(cta_end, end);
  }

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CONSUMERS * 4);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMERS * 4) {  // producer: its first lane issues every load
    if constexpr (Cfg<HD>::WIDE) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    }
    if (warp == CONSUMERS * 4 && lane == 0) {
      const int hk = h / group;
      mbar_expect_tx(&sm.q_full, BQ * HD * 2);
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) tma_load(sm.q + c * BQ * 8, &tm_q, &sm.q_full, 8 * c, h, q0, b);
      for (int kt = cta_begin; kt < cta_end; ++kt) {
        const int i = kt - cta_begin, stage = i % STAGES, use = i / STAGES;
        if (use > 0) mbar_wait(&sm.empty[stage], (use - 1) & 1);
        mbar_expect_tx(&sm.full[stage], 2 * BK * HD * 2);
#pragma unroll
        for (int c = 0; c < HD / 8; ++c) {
          tma_load(sm.k[stage] + c * BK * 8, &tm_k, &sm.full[stage], 8 * c, hk, kt * BK, b);
          tma_load(sm.v[stage] + c * BK * 8, &tm_v, &sm.full[stage], 8 * c, hk, kt * BK, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows q0 + 64 wg + [0, 64)
  if constexpr (Cfg<HD>::WIDE) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  }
  const int wg = warp / 4, wl = warp % 4;
  const int first = q0 + 64 * wg, last = min(first + 63, S - 1);
  int my_begin = 0, my_end = 0;
  if (first <= last) tile_range(first, last, Tk, window, causal, my_begin, my_end);
  const int row_a = first + 16 * wl + lane / 4, row_b = row_a + 8;
  const int col0 = 2 * (lane % 4);

  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  // Q: rows 64 wg.. of [HD/8][BQ][8]; core matrices 128 B apart along M,
  // BQ*16 B apart along K. K: [HD/8][BK][8], likewise. V as the MN-major B
  // operand: 8-key groups 128 B apart (K), 8-dim blocks BK*16 B apart (N).
  const uint64_t dq = gmma_desc(sm.q + 64 * wg * 8, BQ * 16, 128);
  mbar_wait(&sm.q_full, 0);

  for (int kt = cta_begin; kt < cta_end; ++kt) {
    const int i = kt - cta_begin, stage = i % STAGES;
    mbar_wait(&sm.full[stage], (i / STAGES) & 1);
    if (kt >= my_begin && kt < my_end) {
      const int k0 = kt * BK;
      float s[BK / 2];
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) s[j] = 0.f;
      const uint64_t dk = gmma_desc(sm.k[stage], BK * 16, 128);
      fence_regs(s);
      gmma_fence();
#pragma unroll
      for (int t = 0; t < HD / 16; ++t)
        gmma_ss(s, dq + ((t * 2 * BQ * 16) >> 4), dk + ((t * 2 * BK * 16) >> 4), t > 0);
      gmma_commit();
      gmma_wait();
      fence_regs(s);

      const bool need_mask = k0 + BK > Tk || (causal && k0 + BK - 1 > first) ||
                             (window > 0 && k0 <= last - window);
      float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        float v = s[j] * scale_log2;
        if (need_mask) {
          const int col = k0 + 8 * (j / 4) + col0 + (j & 1);
          const int row = (j & 2) ? row_b : row_a;
          if (col >= Tk) {
            v = __int_as_float(0xff800000);  // -inf: past the keys, weighs nothing
          } else if ((causal && col > row) || (window > 0 && col <= row - window)) {
            v = NEG_INF;
          }
        }
        s[j] = v;
        if (j & 2) mx_b = fmaxf(mx_b, v); else mx_a = fmaxf(mx_a, v);
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {  // the four lanes of a row
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float corr_a = exp2f(m_a - mn_a), corr_b = exp2f(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const float p = exp2f(s[j] - ((j & 2) ? mn_b : mn_a));
        s[j] = p;
        if (j & 2) sum_b += p; else sum_a += p;
      }
      l_a = l_a * corr_a + sum_a;
      l_b = l_b * corr_b + sum_b;
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) acc[j] *= (j & 2) ? corr_b : corr_a;

      const uint64_t dv = gmma_desc(sm.v[stage], 128, BK * 16);
      fence_regs(acc);
      gmma_fence();
#pragma unroll
      for (int t = 0; t < BK / 16; ++t) {  // keys 16t .. 16t + 15
        const uint32_t a[4] = {pack_bf16(s[8 * t + 0], s[8 * t + 1]),
                               pack_bf16(s[8 * t + 2], s[8 * t + 3]),
                               pack_bf16(s[8 * t + 4], s[8 * t + 5]),
                               pack_bf16(s[8 * t + 6], s[8 * t + 7])};
        gmma_rs(acc, a, dv + ((t * 16 * 16) >> 4));
      }
      gmma_commit();
      gmma_wait();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[stage]);
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
  __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int j = 0; j < HD / 2; j += 2) {
    const int col = 8 * (j / 4) + col0;
    const int row = (j & 2) ? row_b : row_a;
    const float inv = (j & 2) ? inv_b : inv_a;
    if (row < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + row * os.s + col) =
          __floats2bfloat162_rn(acc[j] * inv, acc[j + 1] * inv);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-d map over x [B, L, N, hd] (element strides sb, ss, sh; unit stride
// over hd), boxes of 8 elements of one head over `rows` rows.
bool encode(CUtensorMap* map, const void* x, int B, int L, int N, int hd, long long sb,
            long long ss, long long sh, int rows) {
  const cuuint64_t dims[4] = {cuuint64_t(hd), cuuint64_t(N), cuuint64_t(L), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(sh) * 2, cuuint64_t(ss) * 2, cuuint64_t(sb) * 2};
  const cuuint32_t box[4] = {8, 1, cuuint32_t(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides,
                   box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int Tk, int H,
           int KV, Strides qs, Strides ks, Strides vs, Strides os, float scale, int window,
           int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (encoder() == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  if (!encode(&tq, q, B, S, H, HD, qs.b, qs.s, qs.h, BQ) ||
      !encode(&tk, k, B, Tk, KV, HD, ks.b, ks.s, ks.h, BK) ||
      !encode(&tv, v, B, Tk, KV, HD, vs.b, vs.s, vs.h, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = static_cast<int>(sizeof(Smem<HD>));
  static_assert(smem <= 232448, "shared memory a CTA may use");
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_wgmma<HD><<<grid, Cfg<HD>::THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), S, Tk, H / KV, os, scale * LOG2E, window,
      causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q [B, S, H, hd], k/v [B, T, KV, hd], o [B, S, H, hd], each with unit
// stride over hd and the given element strides over batch, sequence and
// head; q, k and v 16-byte aligned with strides of a multiple of 8 elements
// (the TMA maps' rule); hd in {32, 64, 80, 128, 256}; scale = hd^-0.5 rounded to
// f32 by the caller. Returns cudaGetLastError() after the launch (0 on
// success), or the error that stopped it before.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int B,
                                    int S, int Tk, int H, int KV, int hd, long long q_sb,
                                    long long q_ss, long long q_sh, long long k_sb,
                                    long long k_ss, long long k_sh, long long v_sb,
                                    long long v_ss, long long v_sh, long long o_sb,
                                    long long o_ss, long long o_sh, float scale, int window,
                                    int causal, void* stream) {
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh};
  const auto st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch<32>(q, k, v, o, B, S, Tk, H, KV, qs, ks, vs, os, scale, window, causal, st);
    case 64: return launch<64>(q, k, v, o, B, S, Tk, H, KV, qs, ks, vs, os, scale, window, causal, st);
    case 80: return launch<80>(q, k, v, o, B, S, Tk, H, KV, qs, ks, vs, os, scale, window, causal, st);
    case 128: return launch<128>(q, k, v, o, B, S, Tk, H, KV, qs, ks, vs, os, scale, window, causal, st);
    case 256: return launch<256>(q, k, v, o, B, S, Tk, H, KV, qs, ks, vs, os, scale, window, causal, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
