// Mamba-2 SSD chunked scan for Hopper (sm_90a), bf16 inputs on the bf16
// tensor cores: stages 1 and 3 of the chain of csrc/ssd_scan.cu. Stage 2
// (the walk over the chunks, f32 elementwise and bound by its bytes) and the
// f32 instances of all three stages stay in csrc/ssd_scan.cu.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan_chunked
// (_ssd_kernel) for bf16 x, B and C. The plain versions are src/repro_torch/
// kernels/ref.py::ssd_chunk_states_ref and ssd_chunk_output_ref; the model
// calls the chain from src/repro_torch/models/ssm.py::apply_ssm under
// use_kernel. What it computes, per (batch, chunk, head), in f32:
//   cum_i  = sum_{j<=i} dt_j a_h                      (stage 1 writes it out)
//   Sc     = sum_j exp(cum_last - cum_j) dt_j B_j (x) x_j         (stage 1)
//   y_i    = sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) dt_j x_j
//            + exp(cum_i) C_i.state_in                             (stage 3)
//
// Design. Every product runs on wgmma (bf16 operands, f32 accumulators in
// registers) from no-swizzle shared-memory tiles: a tile of 128 rows r and
// columns c is stored [c/8][128][8], one 16-byte piece per (row, 8 columns),
// so each 8x8 block is one 128-byte core matrix. The same tile is K-major for
// an operand whose rows are M or N and MN-major for one whose rows are K, so
// a chunk of B serves stage 1 as the M-major A operand B^T and stage 3 as the
// K-major B operand of C.B^T.
//  - Stage 1, ssd_chunk_state_wgmma: one CTA of two warpgroups per (chunk, 8
//    heads, batch), two CTAs an SM. Thread h sums cum of head h in order,
//    f32 products dt_j a added one by one, as torch.cumsum does on the card
//    (so cum is the plain version's, bit for bit, and the wrapper launches
//    no cumsum of its own), writes it out for stages 2 and 3, and the CTA
//    forms w_j = exp(cum_last - cum_j) dt_j. Per head, x arrives by cp.async
//    under the previous head's products, w o x is formed and split (below),
//    and warpgroup g computes state rows n = 64g..64g+63: Sc = B^T.(w o x),
//    m64n64k16 with both operands MN-major.
//  - Stage 3, ssd_chunk_output_wgmma: one CTA of two warpgroups per (chunk, 16
//    heads, batch). S = C.B^T (m64n128k16, K = N = 128) once per CTA, its 8
//    k-steps each into a fresh accumulator and summed in f32 registers (one
//    accumulation chain in the tensor cores moved more outputs); it stays in
//    registers for all 16 heads. Per head, with x and state_in arriving by
//    cp.async under the previous head's products: state_in is split into
//    three MN-major tiles (K = n); Z = C.state_in is issued; W = S o
//    exp(cum_i - cum_j) dt_j is built in the accumulator's own layout, which
//    is the A-operand layout of the next product, two k-steps at a time into
//    two register buffers (the next two built while the tensor cores take
//    the last); Z is scaled by exp(cum_i) row by row (after the product, so
//    C stays exact) and Z += W.x from registers (x MN-major). Rows see keys up to
//    themselves, so warp w of the first warpgroup owns row block w and warp
//    w of the second owns block 7 - w (C's rows are staged in that order):
//    each SM sub-partition runs one short and one long row block. Below a
//    warp's diagonal block the decay is exp(cum_i - cum_r) exp(cum_r - cum_j),
//    r the block's first row: both factors are <= 1 because cum never rises
//    (Mamba-2's dt >= 0 and a < 0), and the warp takes 128 exps for its g
//    row where it took one per element. On the diagonal block the exponent
//    is -inf above the diagonal before the exp (there it could overflow to
//    inf, and inf * 0 is NaN).
//  - The split. B, C and x are bf16 inputs, exact as operands. Three values
//    are f32: W, state_in and w o x. Each goes to the tensor cores as three
//    bf16 pieces, hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid),
//    which hold all 24 bits of v, so each product is the f32 product, in the
//    order small terms first. Two pieces keep 16 bits: over sums of 128
//    terms they moved W.x far enough to change the bf16 rounding of about a
//    thousandth of y (tests/test_torch_ssm.py emulates the arithmetic on the
//    CPU; one piece of w o x misses the states' (5e-4, 1e-3)), which over
//    Mamba2-370M's 16.8M outputs reaches elements of |y| >= 8, a 6.25e-2
//    error. The tensor cores' own accumulation still moves more outputs than
//    the f32 FMA chain of csrc/ssd_scan.cu did (chip_smoke.py phase 9 counts
//    them at Mamba2-370M's shapes).
//
// Bound. At Mamba2-370M's prefill (B 4, S 2048, H 32, P 64, N 128, chunk 128)
// the function reads and writes 73.4 MB (x, y, B, C in bf16; dt, cum f32):
// 0.022 ms at 3.35 TB/s, above its 10.9 GFLOP at 989 TFLOP/s (0.011 ms). The
// chain adds its f32 chunk-state scratch [B, nc, H, N, P], 67 MB: written by
// stage 1, read and written by stage 2, read by stage 3, 268 MB or 0.08 ms,
// and with three pieces the products are about 38 GFLOP, 0.04 ms. So a
// three-stage chain has a floor of about 0.12 ms, set by its own scratch.
// Where the time goes (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 9
// times each stage): stage 3 takes about half of the chain. A CTA walks its
// 16 heads one after another, one CTA an SM (about 225 registers a thread:
// S, the accumulator and W's fragments), and a head's steps follow each
// other behind the CTA's barriers: the state's split, C.state_in, W's build,
// W.x and the stores, each slower than its own throughput would allow. The
// copies of a head (some 3,000 cp.async of 16 bytes) crowd the memory pipe
// that the split and W's build use too. Tried on the card and not kept: a
// producer warp (288 threads caps registers at 168, and ptxas serializes the
// products), splitting the next head's state under C.state_in, and L2
// prefetches of later heads; none made stage 3 faster. Stage 1 waits on its
// 67 MB of scratch stores; stage 2 runs at about 2.1 TB/s. What would move
// it: TMA copies of x and the state (a few instructions a head in place of
// thousands), and fusing stage 1 into stage 2 (one CTA per (batch, head)
// walking its chunks, the state in registers), which removes half of the
// scratch traffic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int QT = 128;       // chunk tile: rows i and j, zero past the chunk
constexpr int NT = 128;       // state tile: n
constexpr int PT = 64;        // head-dim tile: p
constexpr int THREADS = 256;  // two warpgroups
constexpr int HB1 = 8;        // heads per CTA of stage 1
constexpr int HB3 = 16;       // heads per CTA of stage 3: they share S = C.B^T
constexpr int RLD = PT + 4;   // row pitch of the raw f32 state (bank-conflict free)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Make this thread's shared-memory writes (stores and completed cp.async)
// visible to the tensor cores' reads (the async proxy); a barrier then
// publishes them to the CTA.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor, no swizzle: start address, the byte
// distance between core matrices adjacent along K (lbo) and along M/N (sbo).
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// Descriptors of a [c/8][128][8] tile (see the note at the top), and the
// step of one k-block of 16 in descriptor units (16 bytes): K-major, K is c
// (core matrices QT*16 B apart along K, 128 B along M/N); MN-major, K is the
// row (128 B apart along K, QT*16 B along M/N).
__device__ __forceinline__ uint64_t desc_k(const bf16* tile) { return gmma_desc(tile, QT * 16, 128); }
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile) { return gmma_desc(tile, 128, QT * 16); }
constexpr uint64_t STEP_K = 2 * QT * 16 >> 4, STEP_MN = 2 * 128 >> 4;

__device__ __forceinline__ void gmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void gmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void gmma_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
__device__ __forceinline__ void gmma_wait_1() { asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory"); }

// Keep the compiler from reading or writing accumulators across a wgmma
// boundary it cannot see.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The wgmma products (scale-d = accumulate). TA, TB: 1 where the operand is
// MN-major in shared memory.
// d[32] (+)= A (shared) . B (shared), m64n64k16
template <int TA, int TB>
__device__ __forceinline__ void gmma_ss64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// d[64] (+)= A (shared, K-major) . B (shared, K-major), m64n128k16
__device__ __forceinline__ void gmma_ss128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[32] += A (registers) . B (shared, MN-major), m64n64k16
__device__ __forceinline__ void gmma_rs64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
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

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) { return *reinterpret_cast<uint32_t*>(&v); }

// (a, b) -> three bf16 pairs hi = bf16(v), mid = bf16(v - hi), lo =
// bf16(v - hi - mid), each packed as a wgmma A-fragment register (a in the
// low half). Together they hold an f32 value's 24 bits, so hi.op + mid.op +
// lo.op with a bf16 operand op is the f32 product (each term exact in f32).
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const float ra = a - hf.x, rb = b - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(ra, rb);
  const float2 mf = __bfloat1622float2(m);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(ra - mf.x, rb - mf.y));
}

// Eight f32 values (scaled by w) -> one 16-byte piece of each of hi, mid, lo.
__device__ __forceinline__ void split8(const float (&v)[8], float w, uint4& hi, uint4& mid,
                                       uint4& lo) {
  split3(v[0] * w, v[1] * w, hi.x, mid.x, lo.x);
  split3(v[2] * w, v[3] * w, hi.y, mid.y, lo.y);
  split3(v[4] * w, v[5] * w, hi.z, mid.z, lo.z);
  split3(v[6] * w, v[7] * w, hi.w, mid.w, lo.w);
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// e^x as __expf computes it (ex2.approx of x log2 e), flushing results below
// 2^-126 to 0 where __expf keeps them subnormal: fewer instructions for the
// many exps of W, and a difference of under 1.2e-38 in a decay factor.
__device__ __forceinline__ float exp_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// The chunk row of stage 3's tile row r: rows 64..127 hold the 16-row
// blocks 4..7 in reverse order (see the note at the top).
__device__ __forceinline__ int chunk_row(int r) { return r < 64 ? r : 16 * (11 - r / 16) + r % 16; }

// Stage rows [0, rows) and columns [0, cols) of a row-major bf16 block (row
// stride `stride` elements) into a [cols_pad/8][QT][8] tile (tile row r from
// block row chunk_row(r) with `flip`), zero past the block: 16-byte cp.async
// pieces where `vec` (cols and stride multiples of 8, src 16-byte aligned;
// complete after cp_async_wait_all), else element by element. Consecutive
// threads take consecutive rows, so their shared-memory pieces are adjacent.
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src, long long stride, int rows,
                                           int cols, int cols_pad, bool vec, bool flip = false) {
  for (int idx = threadIdx.x; idx < QT * (cols_pad / 8); idx += THREADS) {
    const int r = flip ? chunk_row(idx % QT) : idx % QT, c = 8 * (idx / QT);
    bf16* d = dst + idx * 8;
    if (vec) {
      const bool in = r < rows && c < cols;
      cp_async16(d, in ? src + r * stride + c : src, in);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        d[k] = r < rows && c + k < cols ? src[r * stride + c + k] : __float2bfloat16(0.f);
    }
  }
}

// Stage one head's f32 state [N][P] (contiguous) into dst[n * RLD + p], zero
// past it up to [NT][PT]: 16-byte cp.async pieces where `vec` (P a multiple
// of 4, src 16-byte aligned), else element by element.
__device__ __forceinline__ void stage_state(float* dst, const float* src, int N, int P, bool vec) {
  if (vec) {
    for (int idx = threadIdx.x; idx < NT * PT / 4; idx += THREADS) {
      const int n = idx / (PT / 4), p = 4 * (idx % (PT / 4));
      const bool in = n < N && p < P;
      cp_async16(dst + n * RLD + p, in ? src + n * P + p : src, in);
    }
  } else {
    for (int idx = threadIdx.x; idx < NT * PT; idx += THREADS) {
      const int n = idx / PT, p = idx % PT;
      dst[n * RLD + p] = n < N && p < P ? src[n * P + p] : 0.f;
    }
  }
}

struct StateSmem {
  bf16 bm[NT / 8 * QT * 8];      // B_j[n]: the M-major A operand B^T (M = n, K = j)
  bf16 xr[PT / 8 * QT * 8];      // x_j[p] of the next head as read
  bf16 xw[3][PT / 8 * QT * 8];   // hi, mid, lo of w_j x_j[p]: MN-major B (K = j, N = p)
  float w[HB1][QT];              // dt_j, then w_j = exp(cum_last - cum_j) dt_j, per head
  float cum[HB1][QT];            // cum_j per head
};

// Stage 1. st [B, nc, H, N, P] f32 <- each chunk's own state; cum [B, S, H]
// f32 <- the within-chunk cumulative sum of dt * a_head.
__global__ void __launch_bounds__(THREADS, 2)
ssd_chunk_state_wgmma(const bf16* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ a_head, const bf16* __restrict__ bm,
                      float* __restrict__ st, float* __restrict__ cum, int S, int H, int P, int N,
                      int Q, bool vec_b, bool vec_x) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  StateSmem& sm = *reinterpret_cast<StateSmem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);  // provably warp-uniform for ptxas
  const int c = blockIdx.x, b = blockIdx.z, nc = S / Q;
  const int h0 = blockIdx.y * HB1, nh = min(HB1, H - h0);
  const long long row0 = static_cast<long long>(b) * S + static_cast<long long>(c) * Q;
  const long long xs = static_cast<long long>(H) * P;  // x's row stride

  stage_tile(sm.bm, bm + row0 * N, N, Q, N, NT, vec_b);
  stage_tile(sm.xr, x + (row0 * H + h0) * P, xs, Q, P, PT, vec_x);
  cp_async_commit();

  for (int idx = tid; idx < HB1 * QT; idx += THREADS) {
    const int hh = idx % HB1, j = idx / HB1;
    sm.w[hh][j] = hh < nh && j < Q ? dt[(row0 + j) * H + h0 + hh] : 0.f;
  }
  __syncthreads();
  if (tid < nh) {  // cum of head h0 + tid: the products dt_j a, summed in order
    const int h = h0 + tid;
    const float a = a_head[h];
    float run = 0.f;
    for (int j = 0; j < Q; ++j) {
      run = __fadd_rn(run, __fmul_rn(sm.w[tid][j], a));
      sm.cum[tid][j] = run;
      cum[(row0 + j) * H + h] = run;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < HB1 * QT; idx += THREADS) {  // w_j, in place over dt_j
    const int hh = idx / QT, j = idx % QT;
    if (hh < nh && j < Q) sm.w[hh][j] = expf(sm.cum[hh][Q - 1] - sm.cum[hh][j]) * sm.w[hh][j];
  }

  const uint64_t da = desc_mn(sm.bm + wg * 8 * QT * 8);  // state rows n = 64 wg ..
  const int wl = warp % 4;
  float acc[32];
  for (int hh = 0; hh < nh; ++hh) {
    cp_async_wait_all();
    __syncthreads();  // x of head hh is in; head hh - 1's products are done with xw
    for (int idx = tid; idx < QT * PT / 8; idx += THREADS) {  // w o x, split in three
      const uint4 raw = *reinterpret_cast<const uint4*>(sm.xr + idx * 8);
      const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
      float v[8];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(e[k]);
        v[2 * k] = f.x;
        v[2 * k + 1] = f.y;
      }
      uint4 hi, mid, lo;
      split8(v, sm.w[hh][idx % QT], hi, mid, lo);
      *reinterpret_cast<uint4*>(sm.xw[0] + idx * 8) = hi;
      *reinterpret_cast<uint4*>(sm.xw[1] + idx * 8) = mid;
      *reinterpret_cast<uint4*>(sm.xw[2] + idx * 8) = lo;
    }
    fence_proxy_async();
    __syncthreads();  // xw is written; xr is free for the next head
    if (hh + 1 < nh) {
      stage_tile(sm.xr, x + (row0 * H + h0 + hh + 1) * P, xs, Q, P, PT, vec_x);
      cp_async_commit();
    }

    fence_regs(acc);
    gmma_fence();
#pragma unroll
    for (int piece = 2; piece >= 0; --piece) {  // small terms first
      const uint64_t dx = desc_mn(sm.xw[piece]);
#pragma unroll
      for (int t = 0; t < QT / 16; ++t)
        gmma_ss64<1, 1>(acc, da + t * STEP_MN, dx + t * STEP_MN, piece < 2 || t > 0);
    }
    gmma_commit();
    gmma_wait();
    fence_regs(acc);

    float* out = st + ((static_cast<long long>(b) * nc + c) * H + h0 + hh) * N * P;
#pragma unroll
    for (int k = 0; k < 32; k += 2) {  // rows n, columns p of the accumulator
      const int n = 64 * wg + 16 * wl + lane / 4 + ((k & 2) ? 8 : 0);
      const int p = 8 * (k / 4) + 2 * (lane % 4);
      if (n >= N || p >= P) continue;
      if (P % 2 == 0) {
        *reinterpret_cast<float2*>(out + n * P + p) = make_float2(acc[k], acc[k + 1]);
      } else {
        out[n * P + p] = acc[k];
        if (p + 1 < P) out[n * P + p + 1] = acc[k + 1];
      }
    }
  }
}

struct OutputSmem {
  bf16 c[NT / 8 * QT * 8];       // C_i[n]: K-major A (M = i, K = n)
  bf16 b[NT / 8 * QT * 8];       // B_j[n]: K-major B of C.B^T (N = j, K = n)
  bf16 s[3][PT / 8 * NT * 8];    // hi, mid, lo of state_in[n][p]: MN-major B (K = n, N = p)
  bf16 x[2][PT / 8 * QT * 8];    // x_j[p]: MN-major B (K = j, N = p), one head ahead
  float raw[NT * RLD];           // state_in of the next head as read
  float cum[HB3][QT];            // cum_i per head, 0 past the chunk
  float dt[HB3][QT];             // dt_j per head, 0 past the chunk
  float g[THREADS / 32][QT];     // per warp: exp(cum_r - cum_j) dt_j, r its block's first row
};

// Stage 3. y [B, S, H, P] bf16 from x, dt, cum, B, C and state_in
// [B, nc, H, N, P] f32.
__global__ void __launch_bounds__(THREADS, 1)
ssd_chunk_output_wgmma(const bf16* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ cum, const bf16* __restrict__ bm,
                       const bf16* __restrict__ cm, const float* __restrict__ st,
                       bf16* __restrict__ y, int S, int H, int P, int N, int Q, bool vec_bc,
                       bool vec_x, bool vec_s) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  OutputSmem& sm = *reinterpret_cast<OutputSmem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);  // provably warp-uniform for ptxas
  const int wl = warp % 4;
  const int c = blockIdx.x, b = blockIdx.z, nc = S / Q;
  const int h0 = blockIdx.y * HB3, nh = min(HB3, H - h0);
  const long long row0 = static_cast<long long>(b) * S + static_cast<long long>(c) * Q;
  const long long xs = static_cast<long long>(H) * P;
  const float* st_c = st + ((static_cast<long long>(b) * nc + c) * H) * N * P;  // head 0

  stage_tile(sm.c, cm + row0 * N, N, Q, N, NT, vec_bc, true);
  stage_tile(sm.b, bm + row0 * N, N, Q, N, NT, vec_bc);
  stage_tile(sm.x[0], x + (row0 * H + h0) * P, xs, Q, P, PT, vec_x);
  stage_state(sm.raw, st_c + static_cast<long long>(h0) * N * P, N, P, vec_s);
  for (int idx = tid; idx < HB3 * QT; idx += THREADS) {  // in flight with the tiles
    const int hh = idx % HB3, i = idx / HB3;
    const bool in = hh < nh && i < Q;
    const long long at = in ? (row0 + i) * H + h0 + hh : 0;
    cp_async4(&sm.cum[hh][i], cum + at, in);
    cp_async4(&sm.dt[hh][i], dt + at, in);
  }
  cp_async_commit();

  // this thread's accumulator rows (chunk rows i) and first column pair; its
  // warp's row block: the k-step of W's diagonal block (before it W is full,
  // after it 0) and its first row
  const int block = __shfl_sync(0xffffffffu, wg == 0 ? wl : 7 - wl, 0);  // warp-uniform
  const int row_r = 16 * block, row_a = row_r + lane / 4, row_b = row_a + 8;
  const int t_diag = row_r < Q ? block : -1;  // a block past the chunk has no W
  const int col0 = 2 * (lane % 4);
  const int quarters = 2 * (wg + 1);  // of 2 k-steps of 16 keys j the warpgroup's rows may see
  const uint64_t dc = desc_k(sm.c + 64 * wg * 8), db = desc_k(sm.b);
  float s[64];  // S = C.B^T, rows row_a / row_b, all 128 columns j
  for (int hh = 0; hh < nh; ++hh) {
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();  // x and state_in of head hh are in; head hh - 1 is done
    if (hh + 1 < nh) {
      stage_tile(sm.x[(hh + 1) & 1], x + (row0 * H + h0 + hh + 1) * P, xs, Q, P, PT, vec_x);
      cp_async_commit();
    }
    if (hh == 0) {  // S, its 8 k-steps summed in f32 (closer to the f32 sum than one chain)
#pragma unroll
      for (int t = 0; t < NT / 16; ++t) {
        float part[64];
        fence_regs(part);
        gmma_fence();
        gmma_ss128(part, dc + t * STEP_K, db + t * STEP_K, 0);
        gmma_commit();
        gmma_wait();
        fence_regs(part);
#pragma unroll
        for (int k = 0; k < 64; ++k) s[k] = t > 0 ? s[k] + part[k] : part[k];
      }
    }
    for (int idx = tid; idx < NT * PT / 8; idx += THREADS) {  // state_in, split in three
      const int n = idx % NT, pb = idx / NT;
      const float4 u = *reinterpret_cast<const float4*>(sm.raw + n * RLD + 8 * pb);
      const float4 v = *reinterpret_cast<const float4*>(sm.raw + n * RLD + 8 * pb + 4);
      const float e[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
      uint4 hi, mid, lo;
      split8(e, 1.f, hi, mid, lo);
      *reinterpret_cast<uint4*>(sm.s[0] + idx * 8) = hi;
      *reinterpret_cast<uint4*>(sm.s[1] + idx * 8) = mid;
      *reinterpret_cast<uint4*>(sm.s[2] + idx * 8) = lo;
    }
    fence_proxy_async();
    __syncthreads();  // the split state is written; raw is free for the next head
    if (hh + 1 < nh) {
      stage_state(sm.raw, st_c + static_cast<long long>(h0 + hh + 1) * N * P, N, P, vec_s);
      cp_async_commit();
    }

    float z[32];  // C.state_in, then y
    fence_regs(z);
    gmma_fence();
#pragma unroll
    for (int piece = 2; piece >= 0; --piece) {  // small terms first
      const uint64_t ds = desc_mn(sm.s[piece]);
#pragma unroll
      for (int t = 0; t < NT / 16; ++t)
        gmma_ss64<0, 1>(z, dc + t * STEP_K, ds + t * STEP_MN, piece < 2 || t > 0);
    }
    gmma_commit();

    // W = S o exp(cum_i - cum_j) dt_j, split in three, in the A-fragment
    // layout (register e of k-step t: row_a or row_b by e % 2, columns
    // 16 t + 8 (e / 2) + col0 and + 1). Below the warp's diagonal block, the
    // decay is exp(cum_i - cum_r) exp(cum_r - cum_j) with r the block's first
    // row, both factors <= 1 (cum never rises: dt >= 0, a <= 0), so each
    // thread takes 2 exps for its rows and the warp 128 for its g row. On
    // the diagonal block it is exp(cum_i - cum_j) itself, with the exponent
    // -inf above the diagonal (W is 0 there, and no inf meets a 0). Past the
    // chunk a row's cum is -inf.
    const float* cg = sm.cum[hh];
    const float* dg = sm.dt[hh];
    const float fa = row_a < Q ? cg[row_a] : neg_inf(), fb = row_b < Q ? cg[row_b] : neg_inf();
    float* gw = sm.g[warp];
    for (int j = lane; j < row_r; j += 32) gw[j] = exp_ftz(cg[row_r] - cg[j]) * dg[j];
    __syncwarp();
    const float ra = exp_ftz(fa - cg[row_r]), rb = exp_ftz(fb - cg[row_r]);
    const uint64_t dx = desc_mn(sm.x[hh & 1]);
    // the fragments of k-steps 2q and 2q + 1 into buf
    auto build = [&](int q, uint32_t (&buf)[2][3][4]) {
#pragma unroll
      for (int tt = 0; tt < 2; ++tt) {
        const int t = 2 * q + tt;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float w[2] = {0.f, 0.f};
          const int col = 16 * t + 8 * (e / 2) + col0;
          if (t < t_diag) {
            const float2 g2 = *reinterpret_cast<const float2*>(gw + col);
            const float r = (e & 1) ? rb : ra;
            w[0] = s[8 * t + 2 * e] * r * g2.x;
            w[1] = s[8 * t + 2 * e + 1] * r * g2.y;
          } else if (t == t_diag) {
            const int row = (e & 1) ? row_b : row_a;
            const float f = (e & 1) ? fb : fa;
            const float2 c2 = *reinterpret_cast<const float2*>(cg + col);
            const float2 d2 = *reinterpret_cast<const float2*>(dg + col);
            w[0] = s[8 * t + 2 * e] * exp_ftz(col > row ? neg_inf() : f - c2.x) * d2.x;
            w[1] = s[8 * t + 2 * e + 1] * exp_ftz(col + 1 > row ? neg_inf() : f - c2.y) * d2.y;
          }
          split3(w[0], w[1], buf[tt][0][e], buf[tt][1][e], buf[tt][2][e]);
        }
      }
    };
    // two k-steps of W at a time, in two buffers: the first while C.state_in
    // runs, each next one while the tensor cores take the one before
    uint32_t wf[2][2][3][4];  // [buffer][k-step][hi, mid, lo][register]
    build(0, wf[0]);
    gmma_wait();  // C.state_in is done: scale its rows by exp(cum_i)
    fence_regs(z);
    const float ea = expf(row_a < Q ? fa : 0.f), eb = expf(row_b < Q ? fb : 0.f);
#pragma unroll
    for (int k = 0; k < 32; ++k) z[k] *= (k & 2) ? eb : ea;
    fence_regs(z);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q >= quarters) break;
      gmma_fence();
#pragma unroll
      for (int piece = 2; piece >= 0; --piece)
#pragma unroll
        for (int tt = 0; tt < 2; ++tt)
          gmma_rs64(z, wf[q & 1][tt][piece], dx + (2 * q + tt) * STEP_MN);
      gmma_commit();
      if (q + 1 < quarters) {
        gmma_wait_1();  // the two k-steps before these are done with the other buffer
        build(q + 1, wf[(q + 1) & 1]);
      }
    }
    gmma_wait();
    fence_regs(z);

    bf16* yh = y + (row0 * H + h0 + hh) * P;
#pragma unroll
    for (int k = 0; k < 32; k += 2) {
      const int i = (k & 2) ? row_b : row_a, p = 8 * (k / 4) + col0;
      if (i >= Q || p >= P) continue;
      bf16* dst = yh + i * xs + p;
      if (P % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(z[k], z[k + 1]);
      } else {
        dst[0] = __float2bfloat16(z[k]);
        if (p + 1 < P) dst[1] = __float2bfloat16(z[k + 1]);
      }
    }
  }
}

bool bad_shape(int S, int P, int N, int Q) {
  return Q < 1 || Q > QT || P < 1 || P > PT || N < 1 || N > NT || S % Q != 0;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Layouts: x [B, S, H, P] bf16, dt and cum [B, S, H] f32, a_head [H] f32,
// bm and cm [B, S, N] bf16, y [B, S, H, P] bf16, the state scratch st
// [B, S/Q, H, N, P] f32; all contiguous; chunk Q <= 128 divides S; P <= 64;
// N <= 128. Each returns cudaGetLastError() after its launch (0 on
// success), or the error that refused its shape or shared-memory size.

// st <- each chunk's own state, cum <- dt * a_head summed within each chunk
// (stage 1).
extern "C" int ssd_chunk_state_bf16(const void* x, const float* dt, const float* a_head,
                                    const void* bm, float* st, float* cum, int B, int S, int H,
                                    int P, int N, int Q, void* stream) {
  if (bad_shape(S, P, N, Q)) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = static_cast<int>(sizeof(StateSmem));
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_state_wgmma,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec_b = N % 8 == 0 && aligned16(bm);
  const bool vec_x = P % 8 == 0 && aligned16(x);
  ssd_chunk_state_wgmma<<<dim3(S / Q, (H + HB1 - 1) / HB1, B), THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), dt, a_head, static_cast<const bf16*>(bm), st, cum, S, H, P, N,
      Q, vec_b, vec_x);
  return static_cast<int>(cudaGetLastError());
}

// y <- every chunk's output from its inputs and the state passed into it
// (stage 3).
extern "C" int ssd_chunk_output_bf16(const void* x, const float* dt, const float* cum,
                                     const void* bm, const void* cm, const float* st, void* y,
                                     int B, int S, int H, int P, int N, int Q, void* stream) {
  if (bad_shape(S, P, N, Q)) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = static_cast<int>(sizeof(OutputSmem));
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_output_wgmma,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec_bc = N % 8 == 0 && aligned16(bm) && aligned16(cm);
  const bool vec_x = P % 8 == 0 && aligned16(x);
  const bool vec_s = P % 4 == 0 && aligned16(st);
  ssd_chunk_output_wgmma<<<dim3(S / Q, (H + HB3 - 1) / HB3, B), THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), dt, cum, static_cast<const bf16*>(bm),
      static_cast<const bf16*>(cm), st, static_cast<bf16*>(y), S, H, P, N, Q, vec_bc, vec_x,
      vec_s);
  return static_cast<int>(cudaGetLastError());
}
