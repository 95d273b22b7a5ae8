"""Hand-written Hopper kernels of the port, their plain versions and build.

  * ``rehearsal_ops`` — buffer update+sample (CUDA, ``csrc/rehearsal_ops.cu``)
  * ``ref``           — plain PyTorch version of every kernel
  * ``build``         — nvcc build into ``_build/`` and ctypes loading
"""
