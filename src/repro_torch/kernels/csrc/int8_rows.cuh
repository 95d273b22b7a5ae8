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
//           rounds half to even as jnp.round does)
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

namespace int8rows {

// Record dtype codes, as the Python wrappers pass them.
enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

// Quantize: a cluster of kClusterBlocks blocks per row (Hopper thread block
// clusters), each block reducing and then quantizing one slice of the row.
constexpr int kClusterBlocks = 8;
constexpr int kQuantThreads = 512;
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

__device__ __forceinline__ float block_max(float v, float* smem) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < static_cast<int>(blockDim.x >> 5) ? smem[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) smem[0] = v;
  }
  __syncthreads();
  return smem[0];
}

// The cluster of blocks (kClusterBlocks i, ..., kClusterBlocks i + 7)
// quantizes row i of x [n, len] into row rows[i] of q [n_rows, len] and
// scales [n_rows] (row i itself when rows is null): each block takes the max
// of its slice, the cluster exchanges the eight maxima through distributed
// shared memory, and each block quantizes its slice with the row's scale.
// A target < 0 or >= n_rows is dropped; when several rows target one table
// row, only the last writes it, so no two clusters write the same row and
// the result is the sequential one whatever order the clusters run in. The
// decision is the same for every block of a cluster, so a skipped row's
// cluster leaves before its barrier as a whole.
template <typename T, int VEC>
__global__ void __cluster_dims__(kClusterBlocks, 1, 1)
    quantize_rows_kernel(const T* __restrict__ x, const int* __restrict__ rows,
                         int8_t* __restrict__ q, float* __restrict__ scales,
                         long long n_rows, long long len, int n) {
  __shared__ float smem[32];
  __shared__ float slice_max;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int i = blockIdx.x / kClusterBlocks;
  const int rank = static_cast<int>(cluster.block_rank());
  long long row = i;
  if (rows != nullptr) {
    row = rows[i];
    if (row < 0 || row >= n_rows) return;  // dropped
    for (int k = i + 1; k < n; ++k) {
      if (rows[k] == row) return;  // a later row wins this target
    }
  }
  const long long groups = len / VEC;
  const long long per_block = (groups + kClusterBlocks - 1) / kClusterBlocks;
  const long long begin = rank * per_block;
  const long long end = begin + per_block < groups ? begin + per_block : groups;
  const Group<T, VEC>* xg = reinterpret_cast<const Group<T, VEC>*>(x + i * len);
  float m = 0.0f;
#pragma unroll 4
  for (long long g = begin + threadIdx.x; g < end; g += blockDim.x) {
    const Group<T, VEC> v = xg[g];
#pragma unroll
    for (int u = 0; u < VEC; ++u) m = fmaxf(m, fabsf(to_f32(v.v[u])));
  }
  m = block_max(m, smem);
  if (threadIdx.x == 0) slice_max = m;
  cluster.sync();  // every block's slice max is visible to the cluster
  float amax = 0.0f;
  for (int r = 0; r < kClusterBlocks; ++r) {
    amax = fmaxf(amax, *cluster.map_shared_rank(&slice_max, r));
  }
  cluster.sync();  // no block leaves while another still reads its max
  const float scale = __fmul_rn(fmaxf(amax, 1e-12f), 1.0f / 127.0f);
  Group<int8_t, VEC>* qg = reinterpret_cast<Group<int8_t, VEC>*>(q + row * len);
#pragma unroll 4
  for (long long g = begin + threadIdx.x; g < end; g += blockDim.x) {
    const Group<T, VEC> v = xg[g];
    Group<int8_t, VEC> o;
#pragma unroll
    for (int u = 0; u < VEC; ++u) {
      const float t = fminf(fmaxf(rintf(to_f32(v.v[u]) / scale), -127.0f), 127.0f);
      o.v[u] = static_cast<int8_t>(static_cast<int>(t));
    }
    qg[g] = o;
  }
  if (rank == 0 && threadIdx.x == 0) scales[row] = scale;
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
  const Group<int8_t, VEC>* qg = reinterpret_cast<const Group<int8_t, VEC>*>(q + row * len);
  Group<T, VEC>* og = reinterpret_cast<Group<T, VEC>*>(out + j * len);
#pragma unroll 4
  for (long long g = begin + threadIdx.x; g < end; g += blockDim.x) {
    const Group<int8_t, VEC> v = qg[g];
    Group<T, VEC> o;
#pragma unroll
    for (int u = 0; u < VEC; ++u) o.v[u] = from_f32<T>(static_cast<float>(v.v[u]) * scale);
    og[g] = o;
  }
}

inline bool aligned(const void* p, size_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

template <typename T>
int launch_quantize_typed(const void* x, const int* rows, void* q, void* scales,
                          long long n_rows, long long len, int n, cudaStream_t s) {
  const bool vec4 = len % 4 == 0 && aligned(x, 4 * sizeof(T)) && aligned(q, 4);
  const T* xt = static_cast<const T*>(x);
  int8_t* qt = static_cast<int8_t*>(q);
  float* st = static_cast<float*>(scales);
  const unsigned blocks = static_cast<unsigned>(n) * kClusterBlocks;
  if (vec4) {
    quantize_rows_kernel<T, 4><<<blocks, kQuantThreads, 0, s>>>(xt, rows, qt, st, n_rows, len,
                                                                n);
  } else {
    quantize_rows_kernel<T, 1><<<blocks, kQuantThreads, 0, s>>>(xt, rows, qt, st, n_rows, len,
                                                                n);
  }
  return static_cast<int>(cudaGetLastError());
}

// x [n, len] of `dtype` -> rows of q [n_rows, len] int8 and scales [n_rows]
// f32 (rows null: row i -> row i). Returns cudaGetLastError() after the launch.
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
