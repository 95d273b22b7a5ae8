"""Hand-written Hopper kernels of the port, their plain versions and build.

  * ``rehearsal_ops``   — buffer update+sample, gather-dequant, encode-scatter
                          (CUDA, ``csrc/rehearsal_ops.cu``)
  * ``quantize``        — row-wise int8 quantize / dequantize (``csrc/quantize.cu``)
  * ``flash_attention`` — causal / windowed GQA attention (``csrc/flash_attention.cu``)
  * ``ssd_scan``        — Mamba-2 SSD chunked scan (``csrc/ssd_scan.cu``)
  * ``ref``             — plain PyTorch version of every kernel
  * ``build``           — nvcc build into ``_build/`` and ctypes loading
"""
