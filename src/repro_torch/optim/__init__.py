"""Optimizers of the port."""
from repro_torch.optim.grad_compress import plain_psum
from repro_torch.optim.optimizers import OptState, lr_schedule, make_optimizer

__all__ = ["OptState", "lr_schedule", "make_optimizer", "plain_psum"]
