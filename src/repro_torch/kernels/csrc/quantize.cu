// Row-wise symmetric int8 quantize and dequantize for Hopper (sm_90a): the
// int8 codec of the tiered store's cold tier (unfused form). The unfused
// step launches quantize_rows on its demotion stage; its cold sample is
// dequantized by the update+sample launch that gathers it
// (rehearsal_ops.cu, the dequantizing gather, which runs the same
// dequant_span as dequantize_rows below), so dequantize_rows is no longer
// launched by a train step: it is the batch codec's inverse.
//
// Replaces the TPU kernels src/repro/kernels/quantize.py::quantize_rows
// (_quant_kernel) and ::dequantize_rows (_dequant_kernel); the plain versions
// are src/repro_torch/kernels/ref.py::quantize_rows_ref and
// ::dequantize_rows_ref. The arithmetic is in int8_rows.cuh.
//
// The TPU grid stepped over 8-row tiles held in VMEM, one tile per step. A
// row's scale needs the max over the whole row before any element can be
// quantized, and a CUDA grid has no order between blocks. Quantize therefore
// gives each row a thread block cluster of 8 blocks (Hopper). Each block
// loads its slice of the row into registers, every load in flight at once,
// and reduces it; each block pushes its max into every peer's shared memory
// with st.async and waits on its own mbarrier for theirs; each block
// quantizes its slice from the registers it loaded and stores it 16 bytes a
// lane. One read of x, and no cluster barrier between the loads and the
// stores. Dequantize needs no reduction and spreads each row over many
// blocks. Ragged row counts need no padding: the grid is as long as the
// batch.
//
// Bound. Both are byte-bound on HBM (a few operations per element, far below
// the card's 67 TFLOP/s f32 rate). On the tiered path quantize reads the
// f32 demotion stage [8, 150528] (4.8 MB) and writes int8 rows and scales
// (1.2 MB); dequantize reads 2 int8 rows (0.3 MB) and writes 2 f32 rows
// (1.2 MB). At 3.35 TB/s that is about 1.8 us and 0.45 us, so launch latency
// is most of what either takes (launch_floor below measures it): why the
// dequantization was folded into a launch the step makes anyway.
#include "int8_rows.cuh"

namespace {

__global__ void empty_kernel() {}
__global__ void __cluster_dims__(int8rows::kClusterBlocks, 1, 1) empty_cluster_kernel() {}

}  // namespace

// x [n, len] of `dtype` (0 f32, 1 bf16, 2 f16) -> q [n, len] int8 and
// scales [n] f32. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int quantize_rows(const void* x, void* q, void* scales, long long n,
                             long long len, int dtype, void* stream) {
  return int8rows::launch_quantize(x, nullptr, q, scales, n, len, static_cast<int>(n), dtype,
                                   stream);
}

// quantize_rows of f32 x stopped after `phases` of its three phases (1: load
// and reduce; 2: and the scale; 3: all), to time each phase. Not a product
// path. Returns cudaGetLastError() after the launch.
extern "C" int quantize_rows_phases(const void* x, void* q, void* scales, long long n,
                                    long long len, int phases, void* stream) {
  return int8rows::launch_quantize_phases(x, q, scales, n, len, phases, stream);
}

// An empty kernel of `blocks` blocks of the quantizer's size, launched as
// the int8 kernels are: a plain grid (clustered 0) or clusters of 8 blocks
// (clustered 1, `blocks` a multiple of 8). Its time is the launch floor
// under every kernel's.
extern "C" int launch_floor(int blocks, int clustered, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (clustered) {
    empty_cluster_kernel<<<blocks, int8rows::kQuantThreads, 0, s>>>();
  } else {
    empty_kernel<<<blocks, int8rows::kQuantThreads, 0, s>>>();
  }
  return static_cast<int>(cudaGetLastError());
}

// q [n, len] int8 and scales [n] f32 -> out [n, len] of `dtype`.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int dequantize_rows(const void* q, const void* scales, void* out, long long n,
                               long long len, int dtype, void* stream) {
  return int8rows::launch_dequantize(q, scales, nullptr, out, n, len, static_cast<int>(n),
                                     dtype, stream);
}
