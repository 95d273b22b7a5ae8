// Rehearsal buffer kernels for Hopper (sm_90a).
//
// 1. rehearsal_update_sample: scatter the accepted candidates into the
//    [R, row_bytes] record table in place, then gather the sampled
//    representatives from the updated table.
//
// Replaces the TPU kernel src/repro/kernels/rehearsal_ops.py::
// rehearsal_update_sample, both its single-row form (_update_sample_single /
// _kernel) and its tiled form (_update_sample_tiled / _tiled_kernel); the
// oracle is src/repro/kernels/ref.py::rehearsal_update_sample_ref.
//
// Semantics: candidate i with cand_rows[i] < 0 or >= R is dropped; when
// several candidates target one row the last one wins; representative j is
// row clamp(samp_rows[j], 0, R-1) of the table AFTER the writes.
//
// Ordering. On the TPU the sequential grid is the lock: every scatter step
// runs before any gather step, and duplicate targets resolve in candidate
// order. A CUDA grid runs its blocks in no order, so this kernel needs no
// order at all:
//   * a scatter block for candidate i skips it when a later valid candidate
//     targets the same row, so each row is written by exactly one block;
//   * a gather block for sample j reads from cands[k] when k is the last
//     valid candidate targeting its row, and from the table otherwise -- in
//     which case no block writes that row.
// No block reads a row that another block writes, so one launch with every
// block in parallel gives the sequential result bit for bit.
//
// Bound. The kernel does no arithmetic: it moves (2 * accepted + 2 * sampled)
// rows of row_bytes each. On the main path (c = 4 expected accepted, r = 2
// sampled, 602,112-byte image rows) that is about 7 MB, about 2 us at
// 3.35 TB/s, so launch latency dominates. Rows are split into 32 KB chunks
// across grid.y so a handful of rows still spreads over many SMs, and each
// thread moves 16 bytes per load where row width and pointers allow, 4-byte
// words where they allow that, and single bytes otherwise, so one kernel
// serves f32 image rows, i32 scalar rows and int8 cold-tier rows of any
// width. The table may be pinned host memory (the tiered store's cold tier):
// its rows then cross the host link, which bounds the kernel instead of HBM.
//
// 2. gather_dequant_rows and 3. encode_scatter_rows: the fused kernels of the
// tiered store's cold tier, see below.
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kChunkBytes = 32 * 1024;
constexpr long long kMaxGridY = 65535;

template <typename V>
__device__ __forceinline__ void copy_range(char* dst, const char* src,
                                           long long begin, long long end) {
  const V* s = reinterpret_cast<const V*>(src + begin);
  V* d = reinterpret_cast<V*>(dst + begin);
  const long long n = (end - begin) / static_cast<long long>(sizeof(V));
  for (long long k = threadIdx.x; k < n; k += blockDim.x) d[k] = s[k];
}

template <typename V>
__global__ void update_sample_kernel(char* __restrict__ buffer,
                                     const char* __restrict__ cands,
                                     const int* __restrict__ cand_rows,
                                     const int* __restrict__ samp_rows,
                                     char* __restrict__ reps,
                                     long long n_rows, long long row_bytes,
                                     int n_cand) {
  const int i = blockIdx.x;
  const char* src;
  char* dst;
  if (i < n_cand) {  // scatter candidate i
    const int row = cand_rows[i];
    if (row < 0 || row >= n_rows) return;  // dropped
    for (int k = i + 1; k < n_cand; ++k) {
      if (cand_rows[k] == row) return;  // a later candidate wins this row
    }
    src = cands + static_cast<long long>(i) * row_bytes;
    dst = buffer + static_cast<long long>(row) * row_bytes;
  } else {  // gather sample j from the post-update table
    const int j = i - n_cand;
    long long row = samp_rows[j];
    row = row < 0 ? 0 : (row >= n_rows ? n_rows - 1 : row);
    src = buffer + row * row_bytes;
    for (int k = n_cand - 1; k >= 0; --k) {
      if (cand_rows[k] == row) {  // this step's write to the row
        src = cands + static_cast<long long>(k) * row_bytes;
        break;
      }
    }
    dst = reps + static_cast<long long>(j) * row_bytes;
  }
  for (long long c = blockIdx.y; c * kChunkBytes < row_bytes; c += gridDim.y) {
    const long long begin = c * kChunkBytes;
    const long long end =
        begin + kChunkBytes < row_bytes ? begin + kChunkBytes : row_bytes;
    copy_range<V>(dst, src, begin, end);
  }
}

template <typename V>
void launch_update_sample(dim3 grid, cudaStream_t s, void* buffer, const void* cands,
                          const void* cand_rows, const void* samp_rows, void* reps,
                          long long n_rows, long long row_bytes, int n_cand) {
  update_sample_kernel<V><<<grid, kThreads, 0, s>>>(
      static_cast<char*>(buffer), static_cast<const char*>(cands),
      static_cast<const int*>(cand_rows), static_cast<const int*>(samp_rows),
      static_cast<char*>(reps), n_rows, row_bytes, n_cand);
}

}  // namespace

// buffer [n_rows, row_bytes] (updated in place; device or pinned host
// memory); cands [n_cand, row_bytes]; cand_rows i32[n_cand]; samp_rows
// i32[n_samp]; reps [n_samp, row_bytes]. Any row width and alignment.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int rehearsal_update_sample(void* buffer, const void* cands,
                                       const void* cand_rows,
                                       const void* samp_rows, void* reps,
                                       long long n_rows, long long row_bytes,
                                       int n_cand, int n_samp, void* stream) {
  using int8rows::aligned;
  const int blocks = n_cand + n_samp;
  if (blocks <= 0 || row_bytes <= 0) return static_cast<int>(cudaSuccess);
  long long chunks = (row_bytes + kChunkBytes - 1) / kChunkBytes;
  if (chunks > kMaxGridY) chunks = kMaxGridY;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(chunks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto fits = [&](size_t w) {
    return row_bytes % static_cast<long long>(w) == 0 && aligned(buffer, w) &&
           aligned(cands, w) && aligned(reps, w);
  };
  if (fits(16)) {
    launch_update_sample<uint4>(grid, s, buffer, cands, cand_rows, samp_rows, reps, n_rows,
                                row_bytes, n_cand);
  } else if (fits(4)) {
    launch_update_sample<uint32_t>(grid, s, buffer, cands, cand_rows, samp_rows, reps,
                                   n_rows, row_bytes, n_cand);
  } else {
    launch_update_sample<uint8_t>(grid, s, buffer, cands, cand_rows, samp_rows, reps,
                                  n_rows, row_bytes, n_cand);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The fused cold-tier kernels (arithmetic in int8_rows.cuh).
//
// gather_dequant_rows replaces the TPU kernel src/repro/kernels/
// rehearsal_ops.py::gather_dequant_rows (_gather_dequant_kernel) together
// with its wrapper src/repro/kernels/ops.py::gather_dequant: it reads S int8
// table rows and their scales (rows clamped into range) and writes them
// dequantized, with no int8 or fp intermediate batch. The TPU kernel DMA'd
// 8 rows at a time into VMEM; here S x chunks blocks of 128 threads each
// dequantize one slice of one row in registers, 16 bytes a thread, so the
// two sampled rows' reads are all in flight across the host link at once. The scales are read inside the kernel
// rather than gathered beforehand, because the cold tier's scale table lives
// in pinned host memory where no device-side indexing can reach it.
//
// encode_scatter_rows replaces src/repro/kernels/rehearsal_ops.py::
// encode_scatter_rows (_encode_scatter_kernel) together with
// src/repro/kernels/ops.py::encode_scatter: it quantizes staged fp rows and
// writes each int8 row and its scale straight into its target table row,
// with no encoded-batch intermediate. A target < 0 or >= R is dropped and
// duplicates resolve to the last staged row (the TPU's serialised per-row
// DMA); here, as in rehearsal_update_sample, the block of a row that a later
// valid row also targets does nothing, so the blocks need no order, and an
// all-invalid stage leaves the table untouched.
//
// Bound. On the tiered path both tables are pinned host memory, so the host
// link bounds them, not HBM: gather_dequant reads S = 2 int8 rows of 150,528
// bytes over it (and writes 1.2 MB f32 to HBM), encode_scatter writes up to
// 8 int8 rows over it (and reads up to 4.8 MB f32 from HBM). Encode-scatter
// runs one 8-block cluster per staged row (int8_rows.cuh), so a flush of 4
// rows keeps 32 SMs writing across the link.

// q_table [n_rows, len] int8, scales_table [n_rows] f32 (device or pinned
// host); rows i32[n]; out [n, len] of `dtype` (0 f32, 1 bf16, 2 f16).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int gather_dequant_rows(const void* q_table, const void* scales_table,
                                   const void* rows, void* out, long long n_rows,
                                   long long len, int n, int dtype, void* stream) {
  return int8rows::launch_dequantize(q_table, scales_table, static_cast<const int*>(rows),
                                     out, n_rows, len, n, dtype, stream);
}

// x [n, len] of `dtype`; rows i32[n]; q_table [n_rows, len] int8 and
// scales_table [n_rows] f32 updated in place (device or pinned host).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int encode_scatter_rows(const void* x, const void* rows, void* q_table,
                                   void* scales_table, long long n_rows, long long len,
                                   int n, int dtype, void* stream) {
  return int8rows::launch_quantize(x, static_cast<const int*>(rows), q_table, scales_table,
                                   n_rows, len, n, dtype, stream);
}
