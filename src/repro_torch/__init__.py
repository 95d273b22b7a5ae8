"""PyTorch + CUDA port of the asynchronous distributed rehearsal-buffer system.

``repro_torch`` mirrors the layout of the JAX package ``repro`` module by
module, but imports nothing of it: the port keeps its own copies of the
configs and data streams it needs. Entry points run on ``cuda`` by default and
on the CPU only when the caller passes ``device="cpu"`` (see
``repro_torch.device``).

The first slice is the paper's own experiment: class-incremental ResNet
training with the pipelined (one-step-stale) rehearsal buffer, driven by
``repro_torch.scenario.ContinualTrainer``. The buffer's update+sample moves
its bytes through a hand-written CUDA kernel
(``repro_torch.kernels.rehearsal_ops``).
"""
