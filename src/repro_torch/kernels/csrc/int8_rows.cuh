// Row-wise symmetric int8 quantization and dequantization for Hopper
// (sm_90a), shared by quantize.cu (whole batches) and rehearsal_ops.cu (the
// fused cold-tier kernels, which scatter or gather table rows on the way).
//
// Arithmetic, op for op the reference's jitted quantizer
// (src/repro/kernels/quantize.py::_quant_kernel under jit):
//   amax  = max_k |x_k|                 (order-free, so exact in any layout)
//   scale = fmaxf(amax, 1e-12f) * f32(1/127)   (a product, rounded once)
//   q_k   = clamp(rint(x_k / scale), -127, 127) (IEEE division: the build
//           keeps nvcc's default -prec-div=true, no --use_fast_math; rint
//           rounds half to even as jnp.round does; quant() below rounds
//           with an exact addition in place of rintf)
//   x_k   = (float)q_k * scale, cast to the record dtype (round to nearest).
//
// Tables may be device memory or pinned host memory: a kernel reads and
// writes them through their pointers, which unified addressing makes valid
// on the card for both.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace int8rows {

// Record dtype codes, as the Python wrappers pass them.
enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

// Quantize: one thread block cluster of kClusterBlocks blocks per row
// (Hopper). A warp quantizes its slice of the row a tile of kTile values at
// a time, 16 a lane, and holds up to kHold tiles in registers from the load
// to the store.
constexpr int kClusterBlocks = 8;
constexpr int kQuantThreads = 512;
constexpr int kQuantWarps = kQuantThreads / 32;
constexpr int kTile = 512;
constexpr int kHold = 3;
// Dequantize: each thread moves one group per block, so a row spreads over
// many blocks and all of a few rows' bytes are in flight at once (what a
// read across the host link needs).
constexpr int kDequantThreads = 128;
constexpr long long kMaxGridY = 65535;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half_rn(v); }

// VEC consecutive elements moved by one load or store (16 bytes for four
// f32 or sixteen int8, 4 bytes for four int8); VEC = 1 serves any width and
// alignment.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Group {
  T v[VEC];
};

// The 16 values of one tile that a lane holds, as raw bits: 16 * sizeof(T)
// bytes, one 16-byte load or store per uint4.
template <typename T>
struct Tile {
  uint4 w[sizeof(T)];
};

template <typename T>
using RawBits = typename std::conditional<sizeof(T) == 4, uint32_t, uint16_t>::type;

__device__ __forceinline__ uint32_t word_of(const uint4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

// Value s (0..15) of a tile; s is a constant once the loops are unrolled, so
// this is register moves and, for bf16 and f16, the conversion intrinsic.
template <typename T>
__device__ __forceinline__ float tile_value(const Tile<T>& t, int s);
template <>
__device__ __forceinline__ float tile_value<float>(const Tile<float>& t, int s) {
  return __uint_as_float(word_of(t.w[s >> 2], s & 3));
}
template <typename T>
__device__ __forceinline__ unsigned short tile_half(const Tile<T>& t, int s) {
  const uint32_t w = word_of(t.w[s >> 3], (s >> 1) & 3);
  return static_cast<unsigned short>((s & 1) ? (w >> 16) : (w & 0xffffu));
}
template <>
__device__ __forceinline__ float tile_value<__nv_bfloat16>(const Tile<__nv_bfloat16>& t, int s) {
  return to_f32(__ushort_as_bfloat16(tile_half(t, s)));
}
template <>
__device__ __forceinline__ float tile_value<__half>(const Tile<__half>& t, int s) {
  return to_f32(__ushort_as_half(tile_half(t, s)));
}

// Load the tile of row xr that starts at element `base`. Vector layout (the
// row's x and q 16-byte aligned, the tile whole): load j of a lane reads the
// 16 bytes at elements base + (32 j + lane) * V, V = 16 / sizeof(T), into
// values j V .. j V + V - 1, so each warp load is 512 contiguous bytes.
// Scalar layout (any width or offset): value s is element base + 32 s + lane,
// 0 past the row's end.
template <typename T>
__device__ __forceinline__ void load_tile(Tile<T>& t, const T* xr, long long base,
                                          long long len, bool vector, int lane) {
  if (vector) {
    const uint4* p = reinterpret_cast<const uint4*>(xr + base) + lane;
#pragma unroll
    for (int j = 0; j < static_cast<int>(sizeof(T)); ++j) t.w[j] = p[32 * j];
    return;
  }
  const RawBits<T>* xb = reinterpret_cast<const RawBits<T>*>(xr);
  uint32_t w[4 * sizeof(T)];
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    const long long e = base + 32 * s + lane;
    const uint32_t b = e < len ? static_cast<uint32_t>(xb[e]) : 0u;
    if constexpr (sizeof(T) == 4) {
      w[s] = b;
    } else if (s & 1) {
      w[s >> 1] |= b << 16;
    } else {
      w[s >> 1] = b;
    }
  }
#pragma unroll
  for (int j = 0; j < static_cast<int>(sizeof(T)); ++j) {
    t.w[j] = make_uint4(w[4 * j], w[4 * j + 1], w[4 * j + 2], w[4 * j + 3]);
  }
}

template <typename T>
__device__ __forceinline__ float tile_max(const Tile<T>& t) {
  float m = 0.0f;
#pragma unroll
  for (int s = 0; s < 16; ++s) m = fmaxf(m, fabsf(tile_value(t, s)));
  return m;
}

// clamp(rint(v / scale), -127, 127) as an int8 in the low byte (the other
// bits are not zero). The division is IEEE; the rounding adds 1.5 * 2^23 to
// the clamped quotient t: the sum lies in [2^23, 2^24), where f32 steps by
// 1, so round-to-nearest-even puts it on 1.5 * 2^23 + rint(t) exactly (1.5 *
// 2^23 is even, so ties go to the even k as rintf's do), and the low byte of
// its bits is rint(t) in two's complement. Clamping before rounding equals
// rounding before clamping because +-127 are integers. Bit for bit rintf's
// result, with one FADD in place of a rounding and a float-to-int
// conversion (FRND and F2I), which ran at a fraction of its rate.
__device__ __forceinline__ uint32_t quant(float v, float scale) {
  const float t = fminf(fmaxf(v / scale, -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(t, 12582912.0f));
}

// Four quantized values s .. s + 3 of a tile, packed little-endian.
template <typename T>
__device__ __forceinline__ uint32_t quant4(const Tile<T>& t, int s, float scale) {
  return __byte_perm(__byte_perm(quant(tile_value(t, s), scale),
                                 quant(tile_value(t, s + 1), scale), 0x0040),
                     __byte_perm(quant(tile_value(t, s + 2), scale),
                                 quant(tile_value(t, s + 3), scale), 0x0040),
                     0x5410);
}

// Quantize a tile into row qr. Vector layout: the int8 values pass through
// the warp's 512-byte `stage` in shared memory so that each lane stores 16
// consecutive bytes with one 16-byte store (512 contiguous bytes a warp, into
// HBM or across the host link). Scalar layout: one byte store a value.
template <typename T>
__device__ __forceinline__ void store_tile(const Tile<T>& t, int8_t* qr, long long base,
                                           long long len, bool vector, float scale, int lane,
                                           uint4* stage) {
  if (vector) {
    constexpr int V = 16 / static_cast<int>(sizeof(T));
#pragma unroll
    for (int j = 0; j < static_cast<int>(sizeof(T)); ++j) {
      if constexpr (V == 4) {  // f32: 4 bytes a load, at byte 128 j + 4 lane of the tile
        reinterpret_cast<uint32_t*>(stage)[32 * j + lane] = quant4(t, 4 * j, scale);
      } else {  // bf16, f16: 8 bytes a load, at byte 256 j + 8 lane
        reinterpret_cast<uint2*>(stage)[32 * j + lane] =
            make_uint2(quant4(t, V * j, scale), quant4(t, V * j + 4, scale));
      }
    }
    __syncwarp();
    reinterpret_cast<uint4*>(qr + base)[lane] = stage[lane];
    __syncwarp();  // the stage is free for the next tile
    return;
  }
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    const long long e = base + 32 * s + lane;
    if (e < len) qr[e] = static_cast<int8_t>(quant(tile_value(t, s), scale));
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// barrier.cluster: every thread of every block of the cluster arrives, and
// a wait returns once all have arrived.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// An mbarrier that completes once `bytes` have landed in this block's shared
// memory (one arrival, by the calling thread).
__device__ __forceinline__ void mbar_init_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(1)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
}

// Store v into `slot` of block `peer`'s shared memory and count its 4 bytes
// on that block's `bar` (st.async: the store carries its own completion).
__device__ __forceinline__ void push_to_peer(float* slot, uint64_t* bar, int peer, float v) {
  uint32_t remote_slot, remote_bar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote_slot) : "r"(smem_u32(slot)), "r"(peer));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote_bar) : "r"(smem_u32(bar)), "r"(peer));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               ::"r"(remote_slot), "r"(__float_as_uint(v)), "r"(remote_bar) : "memory");
}

// Wait until the first phase of `bar` has completed.
__device__ __forceinline__ void mbar_wait_first(uint64_t* bar) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], 0;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)) : "memory");
}

// Cluster i (blocks 8 i .. 8 i + 7) quantizes row i of x [n, len] into row rows[i] of q [n_rows, len] and scales [n_rows] (row i
// itself when rows is null). One pass over the row:
//   1. every warp issues the loads of all its held tiles (up to kHold = 3 a
//      warp: 96 KB of f32 a block in flight) before it uses any, and takes
//      their max;
//   2. each block reduces its max and pushes it into slot [rank] of every
//      peer's shared memory with st.async, which counts the 4 bytes on the
//      peer's mbarrier `slots_full`; each block waits on its own mbarrier
//      for its 8 slots and reduces them. No block reads another's shared
//      memory, and a block leaves only after every peer has written to it.
//      The one cluster barrier (arrive at the start, wait before the pushes,
//      overlapped with the loads) makes sure every peer has started and set
//      up its mbarrier;
//   3. each warp quantizes its held tiles from registers and stores them,
//      16 bytes a lane.
// A slice longer than kHold tiles a warp (a row over 24 K values a block,
// 192 K a cluster) takes the rest one tile at a time, loaded once for the
// max and again, from L2 or HBM, for the store: that path reads those bytes
// twice. The tiered path's row (150,528 values) is held whole.
// A target < 0 or >= n_rows is dropped; when several rows target one table
// row, only the last writes it, so no two clusters write the same row and
// the result is the sequential one whatever order the clusters run in. The
// decision is the same for every block of a cluster, so a skipped row's
// cluster leaves before its barrier as a whole. kPhases < 3 stops after
// phase 1 or 2, to time them alone (launch_quantize_phases).
template <typename T, int kPhases = 3>
__global__ void __cluster_dims__(kClusterBlocks, 1, 1) __launch_bounds__(kQuantThreads)
    quantize_rows_kernel(const T* __restrict__ x, const int* __restrict__ rows,
                         int8_t* __restrict__ q, float* __restrict__ scales,
                         long long n_rows, long long len, int n) {
  __shared__ uint4 stage[kQuantWarps][32];
  __shared__ float warp_max[kQuantWarps];
  __shared__ float slots[kClusterBlocks];
  __shared__ __align__(8) uint64_t slots_full;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int i = blockIdx.x / kClusterBlocks;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  long long row = i;
  if (rows != nullptr) {  // every warp decides alike, 32 later targets a load
    row = rows[i];
    bool skip = row < 0 || row >= n_rows;  // dropped
    for (int k = i + 1 + lane; !skip && k - lane < n; k += 32) {
      skip = __any_sync(0xffffffffu, k < n && rows[k] == row);  // a later row wins it
    }
    if (skip) return;
  }
  const T* xr = x + i * len;
  int8_t* qr = q + row * len;
  const bool aligned_row =
      ((reinterpret_cast<uintptr_t>(xr) | reinterpret_cast<uintptr_t>(qr)) & 15) == 0;
  const long long tiles = (len + kTile - 1) / kTile;
  const long long per_block = (tiles + kClusterBlocks - 1) / kClusterBlocks;
  const long long first = rank * per_block + warp;  // this warp's tiles: first + k kQuantWarps
  const long long end = (rank + 1) * per_block < tiles ? (rank + 1) * per_block : tiles;
  auto vec_tile = [&](long long tile) { return aligned_row && (tile + 1) * kTile <= len; };

  Tile<T> held[kHold];
#pragma unroll
  for (int k = 0; k < kHold; ++k) {
    const long long tile = first + k * kQuantWarps;
    if (tile < end) load_tile(held[k], xr, tile * kTile, len, vec_tile(tile), lane);
  }
  if (threadIdx.x == 0) mbar_init_expect(&slots_full, 4u * kClusterBlocks);
  if constexpr (kPhases > 1) cluster_arrive_relaxed();
  float m = 0.0f;
#pragma unroll
  for (int k = 0; k < kHold; ++k) {
    if (first + k * kQuantWarps < end) m = fmaxf(m, tile_max(held[k]));
  }
  for (long long tile = first + kHold * kQuantWarps; tile < end; tile += kQuantWarps) {
    Tile<T> t;
    load_tile(t, xr, tile * kTile, len, vec_tile(tile), lane);
    m = fmaxf(m, tile_max(t));
  }
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if constexpr (kPhases == 1) return;
  cluster_wait_acquire();  // every peer has started and set up its slots_full
  if (warp == 0) {
    float b = lane < kQuantWarps ? warp_max[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) b = fmaxf(b, __shfl_xor_sync(0xffffffffu, b, o));
    if (lane < kClusterBlocks) push_to_peer(&slots[rank], &slots_full, lane, b);
  }
  mbar_wait_first(&slots_full);  // all 8 maxima have landed here
  float amax = 0.0f;
#pragma unroll
  for (int r = 0; r < kClusterBlocks; ++r) amax = fmaxf(amax, slots[r]);
  const float scale = __fmul_rn(fmaxf(amax, 1e-12f), 1.0f / 127.0f);
  if (rank == 0 && threadIdx.x == 0) scales[row] = scale;
  if constexpr (kPhases == 2) return;

#pragma unroll
  for (int k = 0; k < kHold; ++k) {
    const long long tile = first + k * kQuantWarps;
    if (tile < end) {
      store_tile(held[k], qr, tile * kTile, len, vec_tile(tile), scale, lane, stage[warp]);
    }
  }
  for (long long tile = first + kHold * kQuantWarps; tile < end; tile += kQuantWarps) {
    Tile<T> t;
    load_tile(t, xr, tile * kTile, len, vec_tile(tile), lane);
    store_tile(t, qr, tile * kTile, len, vec_tile(tile), scale, lane, stage[warp]);
  }
}

// One group of VEC int8 values dequantized: (float)q * scale, one FMUL a
// value, cast to T (round to nearest).
template <typename T, int VEC>
__device__ __forceinline__ Group<T, VEC> dequant_group(const Group<int8_t, VEC>& v,
                                                       float scale) {
  Group<T, VEC> o;
#pragma unroll
  for (int u = 0; u < VEC; ++u) o.v[u] = from_f32<T>(static_cast<float>(v.v[u]) * scale);
  return o;
}

// Groups [begin, end) of an int8 row qg, dequantized with `scale` into the
// same groups of og. Thread `tid` of `stride` takes groups begin + tid +
// k * stride and issues UNROLL loads before it stores any, so UNROLL groups
// a thread are in flight at once (what a read across the host link needs).
// The dequantizer of dequantize_rows and gather_dequant_rows, and the
// dequantizing gather of rehearsal_update_sample_leaves.
template <typename T, int VEC, int UNROLL>
__device__ __forceinline__ void dequant_span(const Group<int8_t, VEC>* __restrict__ qg,
                                             float scale, Group<T, VEC>* __restrict__ og,
                                             long long begin, long long end, int tid,
                                             int stride) {
  for (long long base = begin + tid; base < end; base += static_cast<long long>(UNROLL) * stride) {
    Group<int8_t, VEC> v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long g = base + static_cast<long long>(u) * stride;
      if (g < end) v[u] = qg[g];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long g = base + static_cast<long long>(u) * stride;
      if (g < end) og[g] = dequant_group<T, VEC>(v[u], scale);
    }
  }
}

// Block (j, c) dequantizes chunk c of table row clamp(rows[j], 0, n_rows-1)
// (row j itself when rows is null) into row j of out [n, len].
template <typename T, int VEC>
__global__ void dequantize_rows_kernel(const int8_t* __restrict__ q,
                                       const float* __restrict__ scales,
                                       const int* __restrict__ rows, T* __restrict__ out,
                                       long long n_rows, long long len) {
  const int j = blockIdx.x;
  long long row = j;
  if (rows != nullptr) {
    row = rows[j];
    row = row < 0 ? 0 : (row >= n_rows ? n_rows - 1 : row);
  }
  const float scale = scales[row];
  const long long groups = len / VEC;
  const long long per_block = (groups + gridDim.y - 1) / gridDim.y;
  const long long begin = blockIdx.y * per_block;
  const long long end = begin + per_block < groups ? begin + per_block : groups;
  dequant_span<T, VEC, 4>(reinterpret_cast<const Group<int8_t, VEC>*>(q + row * len), scale,
                          reinterpret_cast<Group<T, VEC>*>(out + j * len), begin, end,
                          threadIdx.x, blockDim.x);
}

inline bool aligned(const void* p, size_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

template <typename T, int kPhases = 3>
int launch_quantize_typed(const void* x, const int* rows, void* q, void* scales,
                          long long n_rows, long long len, int n, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>(n) * kClusterBlocks;
  quantize_rows_kernel<T, kPhases><<<blocks, kQuantThreads, 0, s>>>(
      static_cast<const T*>(x), rows, static_cast<int8_t*>(q), static_cast<float*>(scales),
      n_rows, len, n);
  return static_cast<int>(cudaGetLastError());
}

// x [n, len] of `dtype` -> rows of q [n_rows, len] int8 and scales [n_rows]
// f32 (rows null: row i -> row i). Returns cudaGetLastError() after the
// launch (0 on success); a refused cluster launch is returned, not retried.
inline int launch_quantize(const void* x, const int* rows, void* q, void* scales,
                           long long n_rows, long long len, int n, int dtype, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_quantize_typed<float>(x, rows, q, scales, n_rows, len, n, s);
    case kBF16:
      return launch_quantize_typed<__nv_bfloat16>(x, rows, q, scales, n_rows, len, n, s);
    case kF16: return launch_quantize_typed<__half>(x, rows, q, scales, n_rows, len, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The f32 quantizer of x [n, len] into q and scales stopped after `phases`
// (1: load and reduce; 2: and the cluster's scale; 3: all): a timing entry,
// which no product path takes.
inline int launch_quantize_phases(const void* x, void* q, void* scales, long long n,
                                  long long len, int phases, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = static_cast<int>(n);
  switch (phases) {
    case 1: return launch_quantize_typed<float, 1>(x, nullptr, q, scales, n, len, rows, s);
    case 2: return launch_quantize_typed<float, 2>(x, nullptr, q, scales, n, len, rows, s);
    case 3: return launch_quantize_typed<float, 3>(x, nullptr, q, scales, n, len, rows, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_dequantize_typed(const void* q, const void* scales, const int* rows, void* out,
                            long long n_rows, long long len, int n, cudaStream_t s) {
  auto fits = [&](int vec) {
    return len % vec == 0 && aligned(q, vec) && aligned(out, vec * sizeof(T));
  };
  const int vec = fits(16) ? 16 : (fits(4) ? 4 : 1);
  long long chunks = (len / vec + kDequantThreads - 1) / kDequantThreads;
  if (chunks > kMaxGridY) chunks = kMaxGridY;
  const dim3 grid(static_cast<unsigned>(n), static_cast<unsigned>(chunks));
  const int8_t* qt = static_cast<const int8_t*>(q);
  const float* st = static_cast<const float*>(scales);
  T* ot = static_cast<T*>(out);
  if (vec == 16) {
    dequantize_rows_kernel<T, 16><<<grid, kDequantThreads, 0, s>>>(qt, st, rows, ot, n_rows,
                                                                   len);
  } else if (vec == 4) {
    dequantize_rows_kernel<T, 4><<<grid, kDequantThreads, 0, s>>>(qt, st, rows, ot, n_rows, len);
  } else {
    dequantize_rows_kernel<T, 1><<<grid, kDequantThreads, 0, s>>>(qt, st, rows, ot, n_rows, len);
  }
  return static_cast<int>(cudaGetLastError());
}

// rows of q [n_rows, len] int8 and scales [n_rows] f32 -> out [n, len] of
// `dtype` (rows null: row j -> row j; else clamped). Returns
// cudaGetLastError() after the launch.
inline int launch_dequantize(const void* q, const void* scales, const int* rows, void* out,
                             long long n_rows, long long len, int n, int dtype, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (len <= 0 || n_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_dequantize_typed<float>(q, scales, rows, out, n_rows, len, n, s);
    case kBF16:
      return launch_dequantize_typed<__nv_bfloat16>(q, scales, rows, out, n_rows, len, n, s);
    case kF16: return launch_dequantize_typed<__half>(q, scales, rows, out, n_rows, len, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace int8rows
