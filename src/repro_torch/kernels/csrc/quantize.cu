// Row-wise symmetric int8 quantize and dequantize for Hopper (sm_90a): the
// int8 codec of the tiered store's cold tier (unfused form).
//
// Replaces the TPU kernels src/repro/kernels/quantize.py::quantize_rows
// (_quant_kernel) and ::dequantize_rows (_dequant_kernel); the plain versions
// are src/repro_torch/kernels/ref.py::quantize_rows_ref and
// ::dequantize_rows_ref. The arithmetic is in int8_rows.cuh.
//
// The TPU grid stepped over 8-row tiles held in VMEM, one tile per step. A
// row's scale needs the max over the whole row before any element can be
// quantized, and a CUDA grid has no order between blocks. Quantize therefore
// gives each row a thread block cluster of 8 blocks (Hopper): each block
// reduces its slice, the eight maxima meet in distributed shared memory
// behind one cluster barrier, and each block quantizes its slice, re-read
// from L2. One launch, 8 SMs per row instead of one. Dequantize needs no
// reduction and spreads each row over many blocks. Ragged row counts need no
// padding: the grid is as long as the batch.
//
// Bound. Both are byte-bound on HBM (a few operations per element, far below
// the card's 67 TFLOP/s f32 rate). On the tiered path quantize reads the
// f32 demotion stage [8, 150528] (4.8 MB) and writes int8 rows and scales
// (1.2 MB); dequantize reads 2 int8 rows (0.3 MB) and writes 2 f32 rows
// (1.2 MB). At 3.35 TB/s that is about 1.8 us and 0.45 us, so launch latency
// is most of what either takes.
#include "int8_rows.cuh"

// x [n, len] of `dtype` (0 f32, 1 bf16, 2 f16) -> q [n, len] int8 and
// scales [n] f32. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int quantize_rows(const void* x, void* q, void* scales, long long n,
                             long long len, int dtype, void* stream) {
  return int8rows::launch_quantize(x, nullptr, q, scales, n, len, static_cast<int>(n), dtype,
                                   stream);
}

// q [n, len] int8 and scales [n] f32 -> out [n, len] of `dtype`.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int dequantize_rows(const void* q, const void* scales, void* out, long long n,
                               long long len, int dtype, void* stream) {
  return int8rows::launch_dequantize(q, scales, nullptr, out, n, len, static_cast<int>(n),
                                     dtype, stream);
}
