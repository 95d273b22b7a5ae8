"""Optimizers of the port."""
from repro_torch.optim.grad_compress import compressed_psum, init_error_feedback, plain_psum
from repro_torch.optim.optimizers import OptState, lr_schedule, make_optimizer

__all__ = ["OptState", "compressed_psum", "init_error_feedback", "lr_schedule",
           "make_optimizer", "plain_psum"]
