// Rehearsal buffer update+sample for Hopper (sm_90a): scatter the accepted
// candidates into the [R, row_bytes] record table in place, then gather the
// sampled representatives from the updated table.
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
// thread moves 16 bytes per load where row width and pointers allow (4-byte
// words otherwise), so one kernel serves f32 image rows and i32 scalar rows.
#include <cuda_runtime.h>
#include <stdint.h>

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

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// buffer [n_rows, row_bytes] (updated in place); cands [n_cand, row_bytes];
// cand_rows i32[n_cand]; samp_rows i32[n_samp]; reps [n_samp, row_bytes].
// row_bytes must be a multiple of 4 and every pointer 4-byte aligned.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int rehearsal_update_sample(void* buffer, const void* cands,
                                       const void* cand_rows,
                                       const void* samp_rows, void* reps,
                                       long long n_rows, long long row_bytes,
                                       int n_cand, int n_samp, void* stream) {
  const int blocks = n_cand + n_samp;
  if (blocks <= 0 || row_bytes <= 0) return static_cast<int>(cudaSuccess);
  if (row_bytes % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  long long chunks = (row_bytes + kChunkBytes - 1) / kChunkBytes;
  if (chunks > kMaxGridY) chunks = kMaxGridY;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(chunks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec16 = row_bytes % 16 == 0 && aligned16(buffer) &&
                     aligned16(cands) && aligned16(reps);
  if (vec16) {
    update_sample_kernel<uint4><<<grid, kThreads, 0, s>>>(
        static_cast<char*>(buffer), static_cast<const char*>(cands),
        static_cast<const int*>(cand_rows), static_cast<const int*>(samp_rows),
        static_cast<char*>(reps), n_rows, row_bytes, n_cand);
  } else {
    update_sample_kernel<uint32_t><<<grid, kThreads, 0, s>>>(
        static_cast<char*>(buffer), static_cast<const char*>(cands),
        static_cast<const int*>(cand_rows), static_cast<const int*>(samp_rows),
        static_cast<char*>(reps), n_rows, row_bytes, n_cand);
  }
  return static_cast<int>(cudaGetLastError());
}
