// Rehearsal buffer kernels for Hopper (sm_90a).
//
// 1. rehearsal_update_sample_leaves: for every leaf of one record, scatter
//    the accepted candidates into the leaf's [R, row_bytes] record table in
//    place, then gather the sampled representatives from the updated table;
//    all leaves in ONE launch. A leaf may gather through the int8
//    dequantizer (the dequantizing gather, below).
//
// Replaces the TPU kernel src/repro/kernels/rehearsal_ops.py::
// rehearsal_update_sample, both its single-row form (_update_sample_single /
// _kernel) and its tiled form (_update_sample_tiled / _tiled_kernel), which
// the reference calls once per leaf; the oracle is
// src/repro/kernels/ref.py::rehearsal_update_sample_ref, leaf by leaf. With
// a dequantizing leaf it also replaces the unfused cold sample's
// src/repro/kernels/quantize.py::dequantize_rows (_dequant_kernel) on the
// gathered rows: the reference's quantize -> scatter / gather -> dequantize
// chain takes three launches, this one takes two (quantize_rows, then this).
//
// Semantics, for each leaf: candidate i with cand_rows[i] < 0 or >= R is
// dropped; when several candidates target one row the last one wins;
// representative j is row clamp(samp_rows[j], 0, R-1) of the table AFTER
// the writes. The leaves share R, cand_rows and samp_rows, and may differ in
// dtype and row width.
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
// The dequantizing gather. A leaf of int8 rows may name the leaf that holds
// its rows' f32 scales ([R, 1], scattered and gathered as any other leaf)
// and a record dtype (f32, bf16 or f16). Sample j's gather blocks of that
// leaf then write q[row] * scale[row], cast, straight into the record-dtype
// output, and never write the int8 row. They take scale[row] from the same
// source as q[row]: cands[k] and the scale leaf's cands[k] for the last
// valid candidate k targeting the row, the two tables otherwise. So the
// ordering rule above holds for the scale too, and the scatter is unchanged.
// The arithmetic is int8_rows.cuh's dequant_span (one FMUL, then the cast),
// so the output is bit-equal to dequantize_rows of the gathered rows. The
// leaf's chunks are counted in int8 bytes; a chunk's output is 4x (f32) or
// 2x (bf16, f16) its bytes, written 16 bytes a store where the row's width
// and pointers allow.
//
// Design. The grid is one dimension over (leaf, candidate or sample, 32 KB
// chunk of the row); a block finds its leaf in a descriptor table passed by
// value (__grid_constant__: base pointers, row bytes, access width, and for
// a dequantizing leaf its scale pointers and output dtype). Each
// thread of 256 issues 8 independent loads before it stores them, so a 32 KB
// chunk of 16-byte rows is in flight at once: one round trip to memory per
// chunk, where one load at a time per thread held the card near 0.5 TB/s.
// Rows move 16 bytes per access where row width and pointers allow, 4-byte
// words where they allow that, and single bytes otherwise, so one launch
// serves f32 image rows, i32 scalar rows and int8 cold-tier rows together.
//
// Bound. The kernel does no arithmetic: it moves (2 * accepted + 2 * sampled)
// rows of each leaf. On the main path (c = 4 expected accepted, r = 2
// sampled, a 602,112-byte image row and two 4-byte scalar rows) that is
// about 7.2 MB, 2.2 us at 3.35 TB/s, so launch latency and one round trip
// to memory are most of its time. The tables may be pinned host memory (the
// tiered store's cold tier): their rows then cross the host link, which
// bounds the kernel instead of HBM. On the unfused tiered path the launch
// writes 4 int8 rows and their scales across the link, reads 2 back, and
// writes the 2 sampled rows dequantized (1.2 MB f32) to HBM.
//
// 2. gather_dequant_rows and 3. encode_scatter_rows: the fused kernels of the
// tiered store's cold tier, see below.
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;  // loads in flight per thread
constexpr long long kChunkBytes = 16LL * kThreads * kUnroll;  // 32 KB
constexpr int kMaxLeaves = 16;

constexpr int kCopy = -1;  // Leaf::out_dtype of a leaf whose sample is a copy of the row

struct Leaf {
  char* table;            // [n_rows, row_bytes], updated in place
  const char* cands;      // [n_cand, row_bytes]
  char* reps;             // [n_samp, row_bytes], or [n_samp, row_bytes] of out_dtype
  long long row_bytes;
  long long chunks;       // chunks of kChunkBytes per row
  long long first_block;  // the leaf's first block of the grid
  int width;              // bytes (copy) or int8 values (dequantizing) per access: 16, 4 or 1
  int out_dtype;          // kCopy, or the record dtype of the dequantizing gather
  const float* scale_table;  // dequantizing: [n_rows] f32 scales of the table's rows
  const float* scale_cands;  // dequantizing: [n_cand] f32 scales of the candidates
};

struct Leaves {
  Leaf leaf[kMaxLeaves];
  int count;
};

// Copy n elements of V: each thread loads kUnroll elements, then stores
// them. The loads come first in program order and src and dst may alias for
// all the compiler knows, so it keeps them first: kUnroll loads in flight.
template <typename V>
__device__ __forceinline__ void copy_chunk(char* dst, const char* src, long long n) {
  const V* s = reinterpret_cast<const V*>(src);
  V* d = reinterpret_cast<V*>(dst);
  for (long long base = threadIdx.x; base < n; base += kUnroll * kThreads) {
    V r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kThreads;
      if (i < n) r[u] = s[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kThreads;
      if (i < n) d[i] = r[u];
    }
  }
}

// Chunk `chunk` of sample j's dequantizing gather: int8 values [chunk *
// kChunkBytes, +kChunkBytes) of the row q, times `scale`, into row j of the
// leaf's T output.
template <typename T>
__device__ __forceinline__ void dequant_chunk(const Leaf& leaf, const int8_t* q, float scale,
                                              long long j, long long chunk) {
  using int8rows::Group;
  T* out = reinterpret_cast<T*>(leaf.reps) + j * leaf.row_bytes;
  const long long begin = chunk * kChunkBytes;
  const long long end = min(begin + kChunkBytes, leaf.row_bytes);
  switch (leaf.width) {
    case 16:
      int8rows::dequant_span<T, 16, kUnroll>(
          reinterpret_cast<const Group<int8_t, 16>*>(q), scale,
          reinterpret_cast<Group<T, 16>*>(out), begin / 16, end / 16, threadIdx.x, kThreads);
      break;
    case 4:
      int8rows::dequant_span<T, 4, kUnroll>(
          reinterpret_cast<const Group<int8_t, 4>*>(q), scale,
          reinterpret_cast<Group<T, 4>*>(out), begin / 4, end / 4, threadIdx.x, kThreads);
      break;
    default:
      int8rows::dequant_span<T, 1, kUnroll>(
          reinterpret_cast<const Group<int8_t, 1>*>(q), scale,
          reinterpret_cast<Group<T, 1>*>(out), begin, end, threadIdx.x, kThreads);
      break;
  }
}

__global__ void __launch_bounds__(kThreads)
update_sample_kernel(const __grid_constant__ Leaves leaves, const int* __restrict__ cand_rows,
                     const int* __restrict__ samp_rows, long long n_rows, int n_cand) {
  const long long blk = blockIdx.x;
  int li = 0;
  while (li + 1 < leaves.count && leaves.leaf[li + 1].first_block <= blk) ++li;
  const Leaf& leaf = leaves.leaf[li];
  const long long local = blk - leaf.first_block;
  const long long slot = local / leaf.chunks, chunk = local % leaf.chunks;
  const char* src;
  char* dst;
  if (slot < n_cand) {  // scatter candidate slot
    const int i = static_cast<int>(slot);
    const int row = cand_rows[i];
    if (row < 0 || row >= n_rows) return;  // dropped
    for (int k = i + 1; k < n_cand; ++k) {
      if (cand_rows[k] == row) return;  // a later candidate wins this row
    }
    src = leaf.cands + static_cast<long long>(i) * leaf.row_bytes;
    dst = leaf.table + static_cast<long long>(row) * leaf.row_bytes;
  } else {  // gather sample slot - n_cand from the post-update table
    const long long j = slot - n_cand;
    long long row = samp_rows[j];
    row = row < 0 ? 0 : (row >= n_rows ? n_rows - 1 : row);
    int k = n_cand - 1;  // this step's last write to the row, if any
    while (k >= 0 && cand_rows[k] != row) --k;
    src = k >= 0 ? leaf.cands + static_cast<long long>(k) * leaf.row_bytes
                 : leaf.table + row * leaf.row_bytes;
    if (leaf.out_dtype != kCopy) {  // the dequantizing gather: scale from src's side
      const int8_t* q = reinterpret_cast<const int8_t*>(src);
      const float scale = k >= 0 ? leaf.scale_cands[k] : leaf.scale_table[row];
      switch (leaf.out_dtype) {
        case int8rows::kF32: dequant_chunk<float>(leaf, q, scale, j, chunk); break;
        case int8rows::kBF16: dequant_chunk<__nv_bfloat16>(leaf, q, scale, j, chunk); break;
        default: dequant_chunk<__half>(leaf, q, scale, j, chunk); break;
      }
      return;
    }
    dst = leaf.reps + j * leaf.row_bytes;
  }
  const long long begin = chunk * kChunkBytes;
  const long long bytes = min(kChunkBytes, leaf.row_bytes - begin);
  switch (leaf.width) {
    case 16: copy_chunk<uint4>(dst + begin, src + begin, bytes / 16); break;
    case 4: copy_chunk<uint32_t>(dst + begin, src + begin, bytes / 4); break;
    default: copy_chunk<uint8_t>(dst + begin, src + begin, bytes); break;
  }
}

}  // namespace

// Bytes of one value of record dtype `code`, 0 for an unknown code.
inline int dtype_bytes(int code) {
  return code == int8rows::kF32 ? 4 : (code == int8rows::kBF16 || code == int8rows::kF16 ? 2 : 0);
}

// For each of n_leaves leaves: tables[i] [n_rows, row_bytes[i]] (updated in
// place; device or pinned host memory), cands[i] [n_cand, row_bytes[i]],
// reps[i] [n_samp, row_bytes[i]]; cand_rows i32[n_cand] and samp_rows
// i32[n_samp] shared by all leaves. Any row width and alignment; at most
// 16 leaves. out_dtypes (null: every leaf copies) makes leaf i a
// dequantizing leaf when out_dtypes[i] is a record dtype code (0 f32, 1
// bf16, 2 f16; -1 copies): its table and candidates are int8, leaf
// scale_leaves[i] holds their f32 scales (row_bytes 4), and reps[i] is
// [n_samp, row_bytes[i]] of that dtype. The pointer, width and code arrays
// are host memory. Returns cudaGetLastError() after the launch (0 on
// success; 0 without a launch when there is nothing to move).
extern "C" int rehearsal_update_sample_leaves(int n_leaves, void* const* tables,
                                              const void* const* cands, void* const* reps,
                                              const long long* row_bytes,
                                              const int* out_dtypes, const int* scale_leaves,
                                              const void* cand_rows, const void* samp_rows,
                                              long long n_rows, int n_cand, int n_samp,
                                              void* stream) {
  using int8rows::aligned;
  if (n_leaves < 0 || n_leaves > kMaxLeaves || n_cand < 0 || n_samp < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Leaves leaves{};
  const long long slots = static_cast<long long>(n_cand) + n_samp;
  long long blocks = 0;
  for (int i = 0; i < n_leaves && slots > 0; ++i) {
    if (row_bytes[i] <= 0) continue;
    const int out_dtype = out_dtypes == nullptr ? kCopy : out_dtypes[i];
    const int out_bytes = out_dtype == kCopy ? 1 : dtype_bytes(out_dtype);
    if (out_bytes == 0) return static_cast<int>(cudaErrorInvalidValue);
    Leaf& leaf = leaves.leaf[leaves.count++];
    leaf.table = static_cast<char*>(tables[i]);
    leaf.cands = static_cast<const char*>(cands[i]);
    leaf.reps = static_cast<char*>(reps[i]);
    leaf.row_bytes = row_bytes[i];
    leaf.chunks = (row_bytes[i] + kChunkBytes - 1) / kChunkBytes;
    leaf.first_block = blocks;
    leaf.out_dtype = out_dtype;
    if (out_dtype != kCopy) {
      const int s = scale_leaves[i];
      if (s < 0 || s >= n_leaves || s == i || row_bytes[s] != 4) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      leaf.scale_table = static_cast<const float*>(tables[s]);
      leaf.scale_cands = static_cast<const float*>(cands[s]);
    }
    blocks += slots * leaf.chunks;
    // a copy moves w bytes an access; a dequantizing gather reads w int8
    // values and writes w values of out_bytes each
    auto fits = [&](size_t w) {
      return row_bytes[i] % static_cast<long long>(w) == 0 && aligned(tables[i], w) &&
             aligned(cands[i], w) && aligned(reps[i], w * out_bytes);
    };
    leaf.width = fits(16) ? 16 : (fits(4) ? 4 : 1);
  }
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  update_sample_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      leaves, static_cast<const int*>(cand_rows), static_cast<const int*>(samp_rows), n_rows,
      n_cand);
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
// runs one cluster of 8 blocks per staged row (int8_rows.cuh), so a flush
// of 4 rows keeps 32 SMs writing across the link, 512 contiguous bytes a
// warp store, and a dropped row's cluster leaves at once. At 4 rows the copy
// engine itself takes about as long for the same bytes, device to pinned,
// as the kernel does.

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
