"""Hand-written Hopper kernels of the port, their plain versions and build.

  * ``rehearsal_ops``   — buffer update+sample, gather-dequant, encode-scatter
                          (CUDA, ``csrc/rehearsal_ops.cu``)
  * ``quantize``        — row-wise int8 quantize / dequantize (``csrc/quantize.cu``)
  * ``flash_attention`` — causal / windowed GQA attention (``csrc/flash_attention.cu``
                          for f32, ``csrc/flash_attention_sm90.cu`` for bf16)
  * ``ssd_scan``        — Mamba-2 SSD chunked scan, three kernels (``csrc/ssd_scan.cu``)
  * ``ref``             — plain PyTorch version of every kernel
  * ``build``           — nvcc build into ``_build/`` and ctypes loading
"""
